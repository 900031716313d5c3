"""ngsepcore_tpu_torch.distribute against ngsepcore_tpu.distribute (CPU).

The port's mesh is an ordered tuple of torch devices; ["cpu"] * D is D
shards on the CPU, the counterpart of the JAX tests' virtual CPU devices
(tests/conftest.py).  On tests/test_distribute.py's simulated case (60 kb,
2,500 reads) the port's ShardedAlignCallPipeline must render the VCF lines
of the JAX package's AlignCallPipeline byte for byte at 1, 2 and 8
shards, and those of its ShardedAlignCallPipeline at 2.  The sharded span
kernel, the sharded tier-3 sweep, sharded_call_step and
genotype_posteriors must equal the JAX package's: integers exactly,
floats within the tolerance each test states."""
import io

import numpy as np
import pytest
import torch

import ngsepcore_tpu.distribute.mesh as jmesh
import ngsepcore_tpu.distribute.pipeline as jpipe
import ngsepcore_tpu.kernels.genotyping as jg
import ngsepcore_tpu_torch.kernels.genotyping as tg
import ngsepcore_tpu_torch.kernels.pairwise as tpw
from ngsepcore_tpu.align.reads_aligner import ReadsAligner as JAligner
from ngsepcore_tpu.call.fused_pipeline import AlignCallPipeline as JPipeline
from ngsepcore_tpu.call.single_sample import SingleSampleVariantsDetector as JDetector
from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner as TAligner
from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector as TDetector
from ngsepcore_tpu_torch.distribute.mesh import make_reads_mesh, sharded_call_step
from ngsepcore_tpu_torch.distribute.pipeline import (
    ShardedAlignCallPipeline,
    make_sharded_dp_run_all,
    make_sharded_span_kernel,
)
from ngsepcore_tpu_torch.vcf.io import VCFFileWriter as TVCFWriter
from test_distribute import _render, _simulated_case
from test_torch_fused_pipeline import _port_genome, _port_reads
from test_torch_genotyping import HET, MINQ, _check_sites, _span_case

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

T = torch.from_numpy
SITE_INTS = ("site_idx", "bi", "bj", "gq", "depths", "total", "strand_counts")


def _render_port(records) -> list[str]:
    buf = io.StringIO()
    w = TVCFWriter(buf, ["s"])
    for r in records:
        w.write(r)
    return buf.getvalue().splitlines()


def _port_pipeline(tgen, devices):
    return ShardedAlignCallPipeline(
        tgen,
        aligner=TAligner(tgen, device="cpu"),
        detector=TDetector(tgen, sample_id="s", device="cpu"),
        mesh=make_reads_mesh(devices=devices),
    )


@pytest.fixture(scope="module")
def case():
    """The JAX package's unsharded records, and the port's at one shard
    with the first window's span-kernel arguments and the tier-3 sweeps
    it ran."""
    genome, reads = _simulated_case()
    base = _render(JPipeline(
        genome, aligner=JAligner(genome),
        detector=JDetector(genome, sample_id="s"),
    ).run_reads(reads))
    assert len(base) > 20, "simulation produced too few variant records"
    tgen, treads = _port_genome(genome), _port_reads(reads)
    pipe = _port_pipeline(tgen, ["cpu"])
    spans, sweeps = [], []
    span_kernel, dp = pipe._span_kernel, pipe.aligner.dp_run_all_fn

    def span_spy(*args, **kw):
        spans.append((args, kw))
        return span_kernel(*args, **kw)

    def dp_spy(*args, **kw):
        sweeps.append(kw["n_chunks"])
        return dp(*args, **kw)

    pipe._span_kernel, pipe.aligner.dp_run_all_fn = span_spy, dp_spy
    lines = _render_port(pipe.run_reads(treads))
    assert spans and sweeps  # the run went through both sharded functions
    return genome, reads, tgen, treads, base, lines, spans[0]


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_vcf_equals_jax_at_every_mesh_size(case, n_shards):
    _, _, tgen, treads, base, lines1, _ = case
    if n_shards == 1:
        got = lines1
    else:
        got = _render_port(_port_pipeline(tgen, ["cpu"] * n_shards).run_reads(treads))
    assert got == base


def test_vcf_equals_jax_sharded_pipeline_at_two_shards(case):
    genome, reads, _, _, _, lines1, _ = case
    jlines = _render(jpipe.ShardedAlignCallPipeline(
        genome, aligner=JAligner(genome),
        detector=JDetector(genome, sample_id="s"),
        mesh=jmesh.make_reads_mesh(2),
    ).run_reads(reads))
    assert lines1 == jlines


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_span_kernel_equals_jax(case, n_shards):
    """One window of the case (the whole 60 kb sequence, 2^16 positions):
    the port's sharded kernel at D shards against the JAX package's at D
    virtual devices.  Integer fields and n_sites exact; ref_prob and
    logcond within 1e-9 relative of the JAX float64 contraction and 1e-3
    absolute of its default two-float pair (test_torch_genotyping's
    tolerances).  n_flagged is the port's unsharded kernel's: the JAX
    sharded kernel reports its busiest shard's, for its buffer check."""
    args, kw = case[-1]
    pq, meta, start, count, w0, pk, ref, C, het, minq = args
    W = kw["out_size"]
    got = tg.genotype_window_hist_resolve_batch([
        make_sharded_span_kernel(make_reads_mesh(devices=["cpu"] * n_shards))(*args, **kw)
    ])[0]
    plain = tg.genotype_window_hist_resolve_batch([tg.genotype_window_span(*args, **kw)])[0]
    assert got["n_flagged"] == plain["n_flagged"]
    assert got["n_sites"] == plain["n_sites"]
    for f in SITE_INTS + ("ref_prob", "logcond"):
        np.testing.assert_array_equal(got[f], plain[f], err_msg=f)
    # the JAX kernel's inputs as its pipeline makes them: rows padded past
    # every span's bucket, meta int32, packed calls in whole 2^16 chunks
    F = pq.shape[0]
    rows = JPipeline._span_bucket(max(count, 1))
    pad = JPipeline._span_bucket(F)
    jpq = np.zeros((F + pad, pq.shape[1]), np.uint8)
    jpq[:F] = pq.numpy()
    jmeta = np.zeros((F + pad, meta.shape[1]), np.int32)
    jmeta[:F] = meta.numpy()
    jpk = np.full(-(-max(pk.numel(), 1) // (1 << 16)) << 16, -1, np.int32)
    jpk[: pk.numel()] = pk.numpy()
    jargs = (
        jpq, jmeta, np.int32(start), np.int32(count), np.int32(w0), jpk,
        ref.numpy(), C.numpy(), np.float64(het), np.int32(minq),
    )
    kern = jpipe.make_sharded_span_kernel(jmesh.make_reads_mesh(n_shards))
    j_def = kern(*jargs, out_size=W, rows=rows)
    j_exact = kern(*jargs, out_size=W, rows=rows, exact_f64=True)
    assert int(j_def["span_overflow"]) == 0
    _check_sites(got, j_def, j_exact)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_span_kernel_equals_unsharded_on_a_dense_window(n_shards):
    """test_torch_genotyping's dense span case (6,000 reads with 3%
    errors and every quality over a 2^16 window, packed host calls),
    whose unsharded result that file holds against the JAX package: at D
    shards every field, n_flagged included, equals the unsharded
    kernel's, so reads within Lp of a chunk edge count on both sides."""
    rng = np.random.default_rng(11)
    W, w0 = 1 << 16, 5000
    pq, meta, pk, ref = _span_case(rng, W, 6000, w0)
    args = (T(pq), T(meta.astype(np.int64)), 0, 6000, w0, T(pk), T(ref),
            T(jg.snv_contribution_table()), HET, MINQ)
    want, got = tg.genotype_window_hist_resolve_batch([
        tg.genotype_window_span(*args, out_size=W),
        make_sharded_span_kernel(make_reads_mesh(devices=["cpu"] * n_shards))(*args, out_size=W),
    ])
    assert got["n_flagged"] == want["n_flagged"] > 1000
    assert got["n_sites"] == want["n_sites"] > 100
    for f in SITE_INTS + ("ref_prob", "logcond"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _dp_case():
    """310 tier-3 jobs (5 chunks of 64 rows, the last one short) gathered
    from a packed read matrix over a 5 kb genome; tests/test_torch_pairwise
    ::test_dp_run_all_matches_jax's reads."""
    rng = np.random.default_rng(13)
    G = 5000
    concat = rng.integers(0, 4, G).astype(np.int8)
    R, Lp, n = 400, 112, 310
    starts = rng.integers(0, G - 130, R)
    codes = np.full((R, Lp), 4, np.int8)
    lengths = rng.integers(80, 101, R).astype(np.int32)
    strand_r = rng.integers(0, 2, R).astype(np.int32)
    for r in range(R):
        seg = concat[starts[r] : starts[r] + lengths[r]].copy()
        mut = rng.random(len(seg)) < 0.03
        seg[mut] = (seg[mut] + 1) % 4
        if rng.random() < 0.3:  # one small deletion
            p = int(rng.integers(20, 60))
            seg = np.concatenate([seg[:p], seg[p + 2 :], seg[-2:]])
        if strand_r[r]:
            seg = np.where(seg[::-1] < 4, 3 - seg[::-1], 4).astype(np.int8)
        codes[r, : lengths[r]] = seg
    quals = rng.integers(0, 31, (R, Lp)).astype(np.uint8)
    bigpq = (codes.view(np.uint8) & 7) | (quals << 3)
    rows = rng.choice(R, n, replace=False)
    CH, n_chunks = 64, 5
    pad = CH * n_chunks

    def padded(a):
        out = np.zeros(pad, np.int32)
        out[:n] = a
        return out

    jobs = [padded(rows), padded(strand_r[rows]),
            padded(np.maximum(starts[rows] - 3, 0)), padded(lengths[rows] + 6)]
    return bigpq, lengths, concat, jobs, dict(CH=CH, Lq=112, Ls=128, n_chunks=n_chunks)


@pytest.fixture(scope="module")
def dp_case():
    bigpq, lengths, concat, jobs, kw = _dp_case()
    tin = (T(bigpq), T(lengths), T(concat), T(jobs[0].astype(np.int64)), T(jobs[1]),
           T(jobs[2].astype(np.int64)), T(jobs[3]))
    plain = tpw.dp_run_all(*tin, **kw)
    return bigpq, lengths, concat, jobs, kw, tin, plain


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_dp_run_all_equals_plain_and_jax(dp_case, n_shards):
    """5 chunks over 2 shards (3 + 2) and 3 (2 + 2 + 1): every output
    equal to the port's unsharded sweep and to the JAX package's sharded
    one at D virtual devices (which pads to a multiple of D chunks; its
    padded chunks are dropped)."""
    bigpq, lengths, concat, jobs, kw, tin, plain = dp_case
    got = make_sharded_dp_run_all(make_reads_mesh(devices=["cpu"] * n_shards))(*tin, **kw)
    j = jpipe.make_sharded_dp_run_all(jmesh.make_reads_mesh(n_shards))(
        bigpq, lengths, concat, *jobs, **kw
    )
    n = kw["n_chunks"]
    assert set(got) == set(plain) == set(j)
    for k in plain:
        assert got[k].shape[0] == n, k
        assert torch.equal(got[k], plain[k]), k
        assert np.array_equal(got[k].numpy(), np.asarray(j[k])[:n]), k
    assert plain["has_gap"].sum() > 20  # the jobs exercise gapped rows


@pytest.fixture(scope="module")
def call_step_case():
    """__graft_entry__.entry()'s inputs: 16 reads of 128 lanes, window 512."""
    import __graft_entry__

    return __graft_entry__.entry()[1], jg.snv_contribution_table(4, 0.5)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_call_step_equals_jax(call_step_case, n_shards):
    """The port's step at D shards against the JAX package's at D virtual
    devices: scores, tier-1 mismatches and merged counts exact; posteriors
    within 1e-12 relative (10^x on each side)."""
    args, C = call_step_case
    j_score, j_mm, j_counts, j_post = (
        np.asarray(x)
        for x in jmesh.sharded_call_step(jmesh.make_reads_mesh(n_shards), 512, C)(*args)
    )
    score, mm, counts, post = sharded_call_step(
        make_reads_mesh(devices=["cpu"] * n_shards), 512, C
    )(*args)
    np.testing.assert_array_equal(score.numpy(), j_score)
    np.testing.assert_array_equal(mm.numpy(), j_mm)
    np.testing.assert_array_equal(counts.numpy(), j_counts)
    assert counts.sum() > 1000
    np.testing.assert_allclose(post.numpy(), j_post, rtol=1e-12, atol=1e-300)


def test_genotype_posteriors_equals_jax():
    """Random counts with an all-zero row and a row deep enough that most
    genotypes fall past the 10^-20 truncation: logcond bit for bit (terms
    added in XLA:CPU's order), posteriors within 1e-12 relative, the
    truncated entries exactly zero on both sides."""
    rng = np.random.default_rng(3)
    P = 64
    counts = rng.integers(0, 4, (P, 4, jg.N_QBINS)).astype(np.int32)
    counts[5] = 0
    counts[9] = 0
    counts[9, 2, 30] = 40  # 40 calls of allele 2 at Q30
    C = jg.snv_contribution_table()
    j_post, j_logcond = (np.asarray(x) for x in jg.genotype_posteriors(counts, C))
    post, logcond = tg.genotype_posteriors(T(counts), T(C))
    np.testing.assert_array_equal(logcond.numpy(), j_logcond)
    np.testing.assert_allclose(post.numpy(), j_post, rtol=1e-12, atol=1e-300)
    assert np.all(logcond.numpy()[5] == 0)
    zero = j_post[9] == 0
    assert zero.sum() >= 6 and np.all(post.numpy()[9][zero] == 0)
    np.testing.assert_allclose(post.numpy().sum(axis=(1, 2)), 1.0, rtol=1e-12)


def test_read_upload_is_row_sharded(case):
    """Each shard holds 1/D of a batch's rows, on its own device
    (test_distribute.py::test_sharded_seeding_runs_spmd)."""
    tgen = case[2]
    pipe = _port_pipeline(tgen, ["cpu"] * 4)
    blocks = pipe._put_reads(np.zeros((512, 128), np.uint8))
    assert [tuple(b.shape) for b in blocks] == [(128, 128)] * 4
    assert [b.device for b in blocks] == list(pipe.mesh.devices)


def test_mesh_size_must_divide_the_window(case):
    args, kw = case[-1]
    kern = make_sharded_span_kernel(make_reads_mesh(devices=["cpu"] * 3))
    with pytest.raises(ValueError, match=r"3 shards .* 65536 positions"):
        kern(*args, **kw)


def test_cuda_mesh_raises_without_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_reads_mesh(2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_reads_mesh(devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError):
        make_reads_mesh(2)  # no device named
    mesh = make_reads_mesh(3, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.lead == torch.device("cpu")
