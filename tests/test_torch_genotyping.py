"""ngsepcore_tpu_torch's classic-detector and span-scatter genotypers must
give the JAX package's sites on the same counts (CPU).

Integer fields (site positions, genotypes, GQ, depths, strand counts) and
the site order must be identical to the JAX default path's, including a
window whose flagged set overflows JAX's first max_flag (4096) and needs
its grow-and-retry pass.  Float fields: the port contracts in float64, so
ref_prob and logcond are held to the JAX float64 (exact_f64) contraction
at 1e-9 relative (the two sum in different orders) and to the JAX default
two-float float32 pair at 1e-3 absolute (that pair's error bound at
saturating depth is ~1e-4)."""
import numpy as np
import pytest
import torch

import ngsepcore_tpu.kernels.genotyping as jg
import ngsepcore_tpu_torch.kernels.genotyping as tg
from ngsepcore_tpu.align.reads_aligner import ReadsAligner as JAligner
from ngsepcore_tpu.call.fused_pipeline import AlignCallPipeline as JPipeline
from ngsepcore_tpu.call.single_sample import SingleSampleVariantsDetector as JDetector
from ngsepcore_tpu.core.sequences import RawRead as JRawRead
from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner as TAligner
from ngsepcore_tpu_torch.call.fused_pipeline import AlignCallPipeline as TPipeline
from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector as TDetector
from ngsepcore_tpu_torch.core.genome import ReferenceGenome as TGenome
from ngsepcore_tpu_torch.core.sequences import QualifiedSequence as TQS
from ngsepcore_tpu_torch.core.sequences import QualifiedSequenceList as TQSL
from ngsepcore_tpu_torch.core.sequences import RawRead as TRawRead
from test_fused_pipeline import _record_key, _simulate

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

T = torch.from_numpy
HET, MINQ = 0.001, 40
INT_FIELDS = ("site_idx", "bi", "bj", "gq", "depths", "total", "strand_counts")


def _packed_calls(rng, W, var_rate):
    """Packed calls (rel | q<<20 | allele<<25 | strand<<28) over a window:
    per-position depth 0..24, reference alleles with 2% errors (N
    included), het or hom-alt evidence at var_rate of the positions,
    qualities 0..41 clamped to 30, a few skipped (-1) words."""
    ref = rng.integers(0, 4, W).astype(np.int8)
    ref[rng.random(W) < 0.01] = 4
    depth = rng.integers(0, 25, W)
    pos = np.repeat(np.arange(W), depth)
    n = len(pos)
    var = rng.random(W) < var_rate
    alt = (np.clip(ref, 0, 3) + rng.integers(1, 4, W)) % 4
    homalt = rng.random(W) < 0.5
    is_alt = var[pos] & (homalt[pos] | (rng.random(n) < 0.5))
    al = np.where(is_alt, alt[pos], np.clip(ref[pos], 0, 3)).astype(np.int32)
    err = rng.random(n) < 0.02
    al[err] = rng.integers(0, 5, int(err.sum()))
    q = np.minimum(rng.integers(0, 42, n), 30).astype(np.int32)
    st = rng.integers(0, 2, n).astype(np.int32)
    pk = pos.astype(np.int32) | (q << 20) | (al << 25) | (st << 28)
    pk[rng.random(n) < 0.01] = -1
    return ref, pk


def _check_sites(t, j_def, j_exact):
    k = int(j_def["n_sites"])
    assert int(t["n_sites"]) == k > 0
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(t[f]), np.asarray(j_def[f])[:k], err_msg=f
        )
    for f in ("ref_prob", "logcond"):
        np.testing.assert_allclose(
            t[f], np.asarray(j_exact[f])[:k], rtol=1e-9, atol=1e-12, err_msg=f
        )
        np.testing.assert_allclose(
            t[f], np.asarray(j_def[f])[:k], rtol=0, atol=1e-3, err_msg=f
        )


@pytest.fixture(scope="module")
def sparse_case():
    rng = np.random.default_rng(7)
    W = 1 << 16
    ref, pk = _packed_calls(rng, W, 0.12)
    jacc = jg.accumulate_allele_counts_packed(*jg.init_count_tensors_flat(W), pk)
    tacc = tg.accumulate_allele_counts_packed(
        *tg.init_count_tensors_flat(W, device="cpu"), T(pk)
    )
    return W, ref, jacc, tacc


def test_accumulate_allele_counts_packed_equals_jax(sparse_case):
    _, _, jacc, tacc = sparse_case
    for j, t in zip(jacc, tacc):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_genotype_window_sparse_equals_jax_past_first_max_flag(sparse_case):
    W, ref, jacc, tacc = sparse_case
    counts, strand_counts, _, total = jacc
    C = jg.snv_contribution_table()
    args = (counts, strand_counts, total, ref, C, np.float64(HET), np.int32(MINQ))
    first = jg.genotype_window_sparse(*args)
    assert int(first["n_flagged"]) > jg.DEF_MAX_FLAG  # JAX had to grow
    j_def = jg.genotype_window_resolved(*args)
    j_exact = jg.genotype_window_resolved(*args, exact_f64=True)
    t = tg.genotype_window_hist_resolve_batch([
        tg.genotype_window_sparse(
            tacc[0], tacc[1], tacc[3], T(ref), T(C), HET, MINQ
        )
    ])[0]
    assert int(t["n_flagged"]) == int(j_def["n_flagged"])
    assert int(t["n_sites"]) > jg.DEF_MAX_OUT
    _check_sites(t, j_def, j_exact)


def _span_case(rng, W, F, w0):
    """F sorted reads (length 80..100, lanes 112) around a window at concat
    coordinate w0, copied from a random genome with 3% substitutions and
    every quality 0..30, plus packed host calls."""
    Lp = 112
    G = W + 2 * Lp
    genome = rng.integers(0, 4, G).astype(np.int8)
    pred = np.sort(rng.integers(w0 - 100, w0 + W, F))
    ln = rng.integers(80, 101, F)
    strand = rng.integers(0, 2, F)
    codes = np.full((F, Lp), 4, np.int8)
    for i in range(F):
        g0 = pred[i] - (w0 - Lp)
        frag = genome[g0 : g0 + ln[i]].copy()
        sub = rng.random(ln[i]) < 0.03
        frag[sub] = rng.integers(0, 5, int(sub.sum()))
        if strand[i]:  # stored in read orientation: reverse complement
            frag = np.where(frag < 4, 3 - frag, frag)[::-1]
        codes[i, : ln[i]] = frag
    q = rng.integers(0, 31, (F, Lp))
    pq = (codes.astype(np.uint8) & 7) | (q.astype(np.uint8) << 3)
    meta = np.zeros((F, jg.META_COLS), np.int32)
    meta[:, jg.META_PRED] = pred
    meta[:, jg.META_CS] = rng.integers(0, 4, F)
    meta[:, jg.META_CE] = rng.integers(0, 4, F)
    meta[:, jg.META_STRAND] = strand
    meta[:, jg.META_LEN] = ln
    ref = genome[Lp : Lp + W].copy()
    _, pk = _packed_calls(rng, W, 0.05)
    return pq, meta, pk[: 20000], ref


@pytest.mark.parametrize("start,count", [(0, 6000), (1500, 3000)])
def test_genotype_window_span_equals_jax(start, count):
    rng = np.random.default_rng(11)
    W, F, w0 = 1 << 16, 6000, 5000
    pq, meta, pk, ref = _span_case(rng, W, F, w0)
    C = jg.snv_contribution_table()
    span_args = (
        pq, meta, np.int32(start), np.int32(count), np.int32(w0), pk, ref, C,
        np.float64(HET), np.int32(MINQ), W, count,
    )
    j_def = jg.genotype_window_span_resolved(span_args)
    j_exact = jg.genotype_window_span(
        *span_args[:10], out_size=W, rows=count, max_flag=1 << 16,
        max_out=1 << 14, exact_f64=True,
    )
    t = tg.genotype_window_hist_resolve_batch([
        tg.genotype_window_span(
            T(pq), T(meta.astype(np.int64)), start, count, w0, T(pk), T(ref),
            T(C), HET, MINQ, out_size=W,
        )
    ])[0]
    assert int(t["n_flagged"]) == int(j_def["n_flagged"])
    _check_sites(t, j_def, j_exact)


def test_fused_31_quality_levels_equals_jax_span_path():
    """Qualities drawn over all 42 Phred values 0..41 leave 31 distinct
    levels after the 0..30 clamp: more than the histogram's 29, so both
    pipelines genotype through the span-scatter path."""
    genome, reads = _simulate(True)
    rng = np.random.default_rng(5)
    reads = [
        JRawRead(
            name=r.name, sequence=r.sequence,
            qualities=(rng.integers(0, 42, len(r.sequence)) + 33)
            .astype(np.uint8).tobytes().decode("ascii"),
        )
        for r in reads
    ]
    jrec = JPipeline(
        genome, aligner=JAligner(genome),
        detector=JDetector(genome, sample_id="s1"), batch_size=1024,
    ).run_reads(reads)
    seqs = TQSL()
    for s in genome.sequences:
        seqs.add(TQS(name=s.name, codes=np.array(s.codes)))
    tgen = TGenome(seqs)
    tpipe = TPipeline(
        tgen, aligner=TAligner(tgen, device="cpu"),
        detector=TDetector(tgen, sample_id="s1", device="cpu"),
        batch_size=1024, device="cpu",
    )
    took = []
    span = tpipe._genotype_span
    tpipe._genotype_span = lambda *a: took.append(1) or span(*a)
    trec = tpipe.run_reads(
        [TRawRead(name=r.name, sequence=r.sequence, qualities=r.qualities)
         for r in reads]
    )
    assert took == [1]
    jk = [_record_key(r) for r in jrec]
    assert len(jk) > 10
    assert [_record_key(r) for r in trec] == jk
