"""ngsepcore_tpu_torch seeding stack and seed index against the JAX package
on the CPU: canonical k-mers, minimizers, hashes, the fused seed/cluster/
tier-1 screen, the candidate classifier, the minimizer table (build, npz
round trip, bucketized device layout) and the packed genome.  Every
output is integer and must be identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngsepcore_tpu.core.genome import ReferenceGenome as JGenome
from ngsepcore_tpu.core.sequences import QualifiedSequence as JQS
from ngsepcore_tpu.core.sequences import QualifiedSequenceList as JQSL
from ngsepcore_tpu.index.minimizer_table import MinimizerTable as JTable
from ngsepcore_tpu.kernels import kmers as jk
from ngsepcore_tpu.kernels import minimizers as jm
from ngsepcore_tpu.kernels import seeding as js
from ngsepcore_tpu.kernels import tier1 as jt1
from ngsepcore_tpu.math import logmath as jlm
from ngsepcore_tpu_torch.core.genome import ReferenceGenome as TGenome
from ngsepcore_tpu_torch.core.sequences import QualifiedSequence as TQS
from ngsepcore_tpu_torch.core.sequences import QualifiedSequenceList as TQSL
from ngsepcore_tpu_torch.index.minimizer_table import MinimizerTable as TTable
from ngsepcore_tpu_torch.kernels import kmers as tk
from ngsepcore_tpu_torch.kernels import minimizers as tm
from ngsepcore_tpu_torch.kernels import seeding as ts
from ngsepcore_tpu_torch.kernels import tier1 as tt1
from ngsepcore_tpu_torch.math import logmath as tlm

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

T = torch.from_numpy


def _genomes(seed=4):
    """A small two-sequence genome with a repeat family (multi-hit seeds)
    and one N base, built in both packages from the same codes."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, 12000).astype(np.int8)
    b = rng.integers(0, 4, 7000).astype(np.int8)
    seg = a[1000:1600].copy()
    a[6000:6600] = seg
    b[2000:2600] = seg
    b[3000] = 4
    js_, ts_ = JQSL(), TQSL()
    for name, c in (("chrA", a), ("chrB", b)):
        js_.add(JQS(name=name, codes=c.copy()))
        ts_.add(TQS(name=name, codes=c.copy()))
    return JGenome(js_), TGenome(ts_), np.concatenate([a, b])


def _reads(rng, concat, n=300, L=100, Lp=112):
    """Reads sampled from the genome (both strands, a few errors, a few
    short reads), as codes and as packed code|qual<<3 bytes."""
    codes = np.full((n, Lp), 4, np.int8)
    lengths = np.full(n, L, np.int32)
    lengths[::17] = L - 23
    for i in range(n):
        s = int(rng.integers(0, len(concat) - L))
        r = concat[s : s + lengths[i]].copy()
        err = rng.random(len(r)) < 0.01
        r[err] = (r[err] + 1) % 4
        if rng.random() < 0.5:
            r = np.where(r[::-1] < 4, 3 - r[::-1], 4).astype(np.int8)
        codes[i, : len(r)] = r
    quals = rng.integers(0, 31, codes.shape).astype(np.uint8)
    pq = (codes.view(np.uint8) & 7) | (quals << 3)
    return codes, lengths, pq


def test_kmers_minimizers_hashes_match_jax():
    rng = np.random.default_rng(1)
    _, _, concat = _genomes()
    codes, lengths, _ = _reads(rng, concat, n=64)
    codes[5, 40] = 4  # an N inside a read
    for k in (15, 25):
        j = jk.kmer_codes_canonical_2x32(codes, lengths, k)
        t = tk.kmer_codes_canonical_2x32(T(codes), T(lengths), k)
        for a, b in zip(t, j):
            assert np.array_equal(a.numpy(), np.asarray(b))
    hi, lo, flag, valid = (np.array(x) for x in jk.kmer_codes_canonical_2x32(codes, lengths, 25))
    assert np.array_equal(
        tm.minimizer_hash30(T(hi), T(lo)).numpy(),
        np.asarray(jm.minimizer_hash30(jnp.asarray(hi), jnp.asarray(lo))),
    )
    assert np.array_equal(
        tm.lookup_hash32(T(hi), T(lo)).numpy(),
        np.asarray(jm.lookup_hash32(jnp.asarray(hi), jnp.asarray(lo))).astype(np.int64),
    )
    h = np.asarray(jm.minimizer_hash30(jnp.asarray(hi), jnp.asarray(lo)))
    for w in (5, 20):
        assert np.array_equal(
            tm.select_minimizers(T(h), T(valid), w).numpy(),
            np.asarray(jm.select_minimizers(h, valid, w)),
        )
    j = jm.extract_minimizers_canonical(codes, lengths, 25, 20)
    t = tm.extract_minimizers_canonical(T(codes), T(lengths), 25, 20)
    for a, b in zip(t, j):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(tk.rc_code_int64(np.arange(50), 7), jk.rc_code_int64(np.arange(50), 7))


def test_tier1_stats_match_jax():
    rng = np.random.default_rng(2)
    B, L = 200, 64
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    s = q.copy()
    mm = rng.random((B, L)) < rng.uniform(0.0, 0.3, B)[:, None]
    s[mm] = (s[mm] + 1) % 4
    ql = rng.integers(20, L + 1, B).astype(np.int32)
    m = (q != s) & (np.arange(L)[None, :] < ql[:, None])
    for a, b in zip(tt1.tier1_stats_from_mask(T(m), T(ql)), jt1.tier1_stats_from_mask(m, ql)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tt1.tier1_stats(T(q), T(ql), T(s)), jt1.tier1_stats(q, ql, s)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_minimizer_table_and_genome_match_jax(tmp_path):
    jg, tg, concat = _genomes()
    jtab = JTable.build_from_genome(jg)
    ttab = TTable.build_from_genome(tg, device="cpu")
    keys = ("unique_codes", "row_offsets", "entry_pos", "entry_strand")
    for k in keys:
        assert np.array_equal(getattr(ttab, k), getattr(jtab, k)), k
    assert len(jtab.unique_codes) > 500
    path = str(tmp_path / "idx.npz")
    jtab.save(path)
    loaded = TTable.load(path)
    for k in keys:
        assert np.array_equal(getattr(loaded, k), getattr(jtab, k)), k
    assert (loaded.k, loaded.window, loaded.max_hits_per_code) == (
        jtab.k, jtab.window, jtab.max_hits_per_code
    )
    assert np.array_equal(
        loaded.device_arrays("cpu").numpy(), np.asarray(jtab.device_arrays()[0])
    )
    jp, jn2 = jg.device_packed()
    tp, tn2 = tg.device_packed("cpu")
    assert np.array_equal(tp.numpy(), np.asarray(jp).astype(np.int64))
    assert np.array_equal(tn2.numpy(), np.asarray(jn2).astype(np.int64))
    assert np.array_equal(tg.device_concat("cpu").numpy(), concat)
    assert tg.has_n == jg.has_n


@pytest.mark.parametrize("packed,const_len", [(True, None), (False, None), (True, 100)])
def test_seed_screen_and_classify_match_jax(packed, const_len):
    rng = np.random.default_rng(6)
    jg, tg, concat = _genomes()
    codes, lengths, pq = _reads(rng, concat)
    if const_len is not None:
        lengths[:] = const_len
        codes[:, const_len:] = 4
        pq = (codes.view(np.uint8) & 7) | (pq & 0xF8)
    jtab = JTable.build_from_genome(jg)
    ttab = TTable.from_arrays(
        jtab.k, jtab.window, jtab.max_hits_per_code, jtab.unique_codes,
        jtab.row_offsets, jtab.entry_pos, jtab.entry_strand,
    )
    x = pq if packed else codes
    kw = dict(k=25, window=20, genome_len=jg.total_length, const_len=const_len,
              genome_has_n=jg.has_n)
    j = js.seed_cluster_screen(x, lengths, *jtab.device_arrays(), *jg.device_packed(), **kw)
    t = ts.seed_cluster_screen(
        T(x), T(lengths), ttab.device_arrays("cpu"), *tg.device_packed("cpu"), **kw
    )
    for key in j:
        assert np.array_equal(t[key].numpy(), np.asarray(j[key])), key
    assert (np.asarray(j["weight"])[:, 0] > 2).mean() > 0.8

    offs = np.asarray(jg.offsets)
    jc = js.classify_candidates(
        j["pred_start"], j["weight"], j["strand"], j["mismatches"],
        j["clip_start"], j["clip_end"], lengths, jnp.asarray(offs.astype(np.int32)),
        jnp.zeros(1, jnp.int32), jnp.full(1, -1, jnp.int32), np.int32(20),
        has_strs=False,
    )
    tc = ts.classify_candidates(
        t["pred_start"], t["weight"], t["strand"], t["mismatches"],
        t["clip_start"], t["clip_end"], T(lengths), T(offs), 20,
    )
    for key in jc:
        assert np.array_equal(np.asarray(tc[key]), np.asarray(jc[key])), key
    assert np.asarray(jc["fused"]).sum() > 100
    assert np.asarray(jc["cell_mask"]).sum() > 0  # repeat reads reach the host


def test_log10_sum_matches_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(-5, 10, (20, 7))
    v[3] = -np.inf
    j = np.asarray(jlm.jnp_log10_sum(jnp.asarray(v), axis=1))
    t = tlm.torch_log10_sum(T(v), dim=1).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-12)
    assert tlm.log10_sum(-1.0, -3.0) == jlm.log10_sum(-1.0, -3.0)
    assert tlm.log10_sum(None, -3.0) == -3.0
