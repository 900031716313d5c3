"""ngsepcore_tpu_torch pileup and genotyping against the JAX package on the
CPU: the plain shear histogram (what the CUDA kernel is held to on the
card) against `_shear_hist_xla`, the col-byte/stage builders, both
scatters, the call expansion and the window genotyper.

Genotyper tolerances: integer outputs (site indices, genotypes, GQ,
depths, totals, strand counts) must be identical.  logcond and ref_prob
agree with JAX's exact_f64=True path to 1e-9 relative (the same float64
terms, summed in another order) and with JAX's default two-float f32
path to 1e-4 absolute (kernels/genotyping.py:380-386 bounds that path's
error)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngsepcore_tpu.kernels import genotyping as jg
from ngsepcore_tpu.kernels import shear_pileup as jsp
from ngsepcore_tpu_torch.kernels import genotyping as tg
from ngsepcore_tpu_torch.kernels import shear_pileup as tsp

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

T = torch.from_numpy


def _stage(rng, lanes, S, nq, holes=0.3):
    """Random stage bytes: count columns (with and without strand bit),
    N/low columns and 0xFF holes."""
    ncnt = 4 * nq + 2
    col = rng.integers(0, ncnt, (lanes, S))
    strand = rng.integers(0, 2, (lanes, S))
    b = (col | (strand << 7)).astype(np.uint8)
    b[rng.random((lanes, S)) < holes] = 0xFF
    return b


@pytest.mark.parametrize("nq", [1, 3, 29])
def test_shear_hist_ref_matches_xla(nq):
    rng = np.random.default_rng(nq)
    lanes, window = 160, 4096
    S = lanes + window + 64
    st = _stage(rng, lanes, S, nq)
    w0s = lanes - 1  # the smallest legal start: the full halo is read
    j = np.asarray(jsp._shear_hist_xla(st, np.int32(w0s), window=window, nq=nq, lanes=lanes))
    t = tsp.shear_hist_ref(T(st), w0s, window=window, nq=nq, lanes=lanes)
    assert np.array_equal(t.numpy(), j)
    before = tsp.shear_hist.launches
    w = tsp.shear_hist(T(st), w0s + 32, window=window, nq=nq, lanes=lanes)
    assert tsp.shear_hist.launches == before
    j2 = np.asarray(jsp._shear_hist_xla(st, np.int32(w0s + 32), window=window, nq=nq, lanes=lanes))
    assert np.array_equal(w.numpy(), j2)


def test_shear_hist_rejects_out_of_stage_window():
    st = torch.full((16, 100), 255, dtype=torch.uint8)
    with pytest.raises(ValueError):
        tsp.shear_hist_ref(st, 10, window=64, nq=2, lanes=16)  # halo cut
    with pytest.raises(ValueError):
        tsp.shear_hist_ref(st, 40, window=64, nq=2, lanes=16)  # past the end


def _colg_inputs(rng, R=64, Lp=48, nq=3):
    codes = rng.integers(0, 5, (R, Lp)).astype(np.uint8)
    quals = rng.choice(np.array([2, 12, 25, 30]), (R, Lp)).astype(np.uint8)
    pq = codes | (quals << 3)
    rev = rng.integers(0, 2, R).astype(np.uint8)
    ln = rng.integers(Lp // 2, Lp + 1, R)
    cs = rng.integers(0, 4, R)
    ce = rng.integers(0, 4, R)
    alo = np.where(rev == 1, Lp - ln + cs, cs).astype(np.int32)
    ahi = np.where(rev == 1, Lp - ce, ln - ce).astype(np.int32)
    alo[:3] = ahi[:3] = 0  # rows that never contribute
    thr = np.array([2, 12, 25, 30][4 - nq :], np.int32)
    return pq, rev, alo, ahi, thr


def test_colg_stage_and_scatters_match_jax():
    rng = np.random.default_rng(3)
    nq, Lp = 3, 48
    pq, rev, alo, ahi, thr = _colg_inputs(rng, nq=nq, Lp=Lp)
    jc = np.asarray(jsp.build_colg(pq, rev, alo, ahi, thr, nq=nq, lanes=Lp))
    tc = tsp.build_colg(T(pq), T(rev), T(alo), T(ahi), T(thr), nq=nq, lanes=Lp)
    assert np.array_equal(tc.numpy(), jc)

    s_cols = 400
    rows = rng.choice(len(pq), 40, replace=False).astype(np.int32)
    pos = rng.choice(s_cols - 1, 40, replace=False).astype(np.int32)
    js = np.asarray(jsp.build_stage(jc, rows, pos, s_cols=s_cols))
    ts = tsp.build_stage(tc, T(rows.astype(np.int64)), T(pos.astype(np.int64)), s_cols=s_cols)
    assert np.array_equal(ts.numpy(), js)

    W = 256
    hist0 = rng.integers(0, 5, (W, 128)).astype(np.int32)
    res = rng.choice(len(pq), 12, replace=False)
    pred_rel = rng.integers(-Lp, W, 12).astype(np.int32)
    jh = jsp.hist_residual_scatter(
        jnp.asarray(hist0), jnp.asarray(jc[res]), jnp.asarray(pred_rel),
        jnp.ones(12, bool), nq,
    )
    th = tsp.hist_residual_scatter(T(hist0.copy()), tc[T(res)], T(pred_rel), nq)
    assert np.array_equal(th.numpy(), np.asarray(jh))

    n = 500
    packed = (
        rng.integers(0, W, n)
        | (rng.integers(0, 31, n) << 20)
        | (rng.integers(0, 5, n) << 25)
        | (rng.integers(0, 2, n) << 28)
    ).astype(np.int32)
    packed[rng.random(n) < 0.2] = -1
    qual_bin = rng.integers(0, nq, 31).astype(np.int32)
    jh2 = jsp.hist_packed_scatter(
        jnp.asarray(hist0), jnp.asarray(packed), jnp.asarray(qual_bin), nq, 3
    )
    th2 = tsp.hist_packed_scatter(
        T(hist0.copy()), T(packed), T(qual_bin.astype(np.int64)), nq, 3
    )
    assert np.array_equal(th2.numpy(), np.asarray(jh2))

    parts = [pq[:20], pq[20:, :40]]
    jcat = np.asarray(jsp.concat_reads(*parts, lanes=44))
    tcat = tsp.concat_reads(*[T(np.ascontiguousarray(p)) for p in parts], lanes=44)
    assert np.array_equal(tcat.numpy(), jcat)


def test_call_expansion_and_tables_match_jax():
    rng = np.random.default_rng(9)
    R = 300
    run_len = rng.integers(1, 60, R).astype(np.int32)
    run_ref = rng.integers(1, 5000, R).astype(np.int32)
    C = int(run_len.sum()) + 50
    run_src = rng.integers(0, C - 60, R).astype(np.int32)
    run_strand = rng.integers(0, 2, R).astype(np.int32)
    codes = rng.integers(0, 5, C).astype(np.int8)
    quals = rng.integers(0, 41, C).astype(np.int8)
    total = int(run_len.sum())
    N = 1 << (total - 1).bit_length()
    jpos, jattr, jtot = jg.expand_mrun_calls(
        run_ref, run_src, run_len, run_strand, codes, quals, N=N
    )
    tpos, tattr, ttot = tg.expand_mrun_calls(
        T(run_ref), T(run_src), T(run_len), T(run_strand), T(codes), T(quals), N=total
    )
    assert int(ttot) == int(jtot) == total
    jpos, jattr = np.array(jpos)[:total], np.array(jattr)[:total]
    assert np.array_equal(tpos.numpy(), jpos)
    # equal positions may carry their calls in either order: compare the
    # multiset of (pos, attr) pairs (scatters are order-free)
    assert sorted(zip(tpos.tolist(), tattr.tolist())) == sorted(zip(jpos.tolist(), jattr.tolist()))
    lo, w0, cnt = 100, 800, 700
    jpk = np.asarray(jg.window_pk_slice(jpos, jattr, np.int32(lo), np.int32(w0), np.int32(cnt), size=1024))
    tpk = tg.window_pk_slice(T(jpos), T(jattr), lo, w0, cnt, size=1024)
    assert np.array_equal(tpk.numpy(), jpk)

    pq_out = rng.integers(0, 255, (64, 40)).astype(np.uint8)
    pq_batch = rng.integers(0, 255, (30, 48)).astype(np.uint8)
    src = rng.choice(30, 10, replace=False).astype(np.int32)
    dst = rng.choice(64, 10, replace=False).astype(np.int32)
    jo = np.asarray(jg.place_fused_rows(jnp.asarray(pq_out), pq_batch, src, dst))
    to = tg.place_fused_rows(
        T(pq_out.copy()), T(pq_batch), T(src.astype(np.int64)), T(dst.astype(np.int64))
    )
    assert np.array_equal(to.numpy(), jo)

    assert np.array_equal(tg.snv_contribution_table(), jg.snv_contribution_table())
    qlv = np.array([2, 11, 20, 30], np.int32)
    for a, b in zip(tg.hist_tables(4, qlv), jg.hist_tables(4, qlv)):
        assert np.array_equal(a, b)


def _window_case(rng, window=2048, lanes=160, nq=3):
    """Dense stage with low-coverage noise plus a few strong alt
    positions, residual reads and host packed calls."""
    ncnt = 4 * nq + 2
    S = lanes + window + 64
    ref = rng.integers(0, 4, window).astype(np.int8)
    ref[-40:] = 4
    w0s = lanes - 1
    # per stage column, lane o reads genome position p = col - w0s + o
    st = np.full((lanes, S), 0xFF, np.uint8)
    cover = rng.random((lanes, S)) < 0.12
    p = np.arange(S)[None, :] - w0s + np.arange(lanes)[:, None]
    pc = np.clip(p, 0, window - 1)
    al = ref[pc].astype(np.int64)
    al = np.where(al == 4, 0, al)
    alt_sites = rng.choice(window - 100, 25, replace=False)
    is_alt = np.isin(pc, alt_sites) & (rng.random((lanes, S)) < 0.55)
    al = np.where(is_alt, (al + 1) % 4, al)
    noise = rng.random((lanes, S)) < 0.01
    al = np.where(noise, rng.integers(0, 4, (lanes, S)), al)
    qb = rng.integers(0, nq, (lanes, S))
    col = al * nq + qb
    col = np.where(rng.random((lanes, S)) < 0.005, ncnt - 2, col)  # N
    col = np.where(rng.random((lanes, S)) < 0.005, ncnt - 1, col)  # low q
    strand = rng.integers(0, 2, (lanes, S))
    st[cover] = (col | (strand << 7))[cover].astype(np.uint8)
    Fall, Lp = 50, lanes
    colg = _stage(rng, Fall, Lp, nq, holes=0.2)
    res_idx = rng.choice(Fall, 10, replace=False).astype(np.int32)
    res_pred = rng.integers(-Lp, window, 10).astype(np.int32)
    n_pk = 3000
    pkpos = rng.integers(0, window, n_pk)
    pk = (
        pkpos
        | (rng.choice(np.array([2, 12, 20, 30]), n_pk) << 20)
        | (ref[pkpos].clip(0, 3).astype(np.int64) << 25)
        | (rng.integers(0, 2, n_pk) << 28)
    ).astype(np.int32)
    qlv = np.array([12, 20, 30][:nq], np.int32)
    return st, w0s, colg, res_idx, res_pred, pk, ref, qlv


def test_genotype_window_hist_matches_jax():
    rng = np.random.default_rng(21)
    window, lanes, nq = 2048, 160, 3
    st, w0s, colg, res_idx, res_pred, pk, ref, qlv = _window_case(
        rng, window, lanes, nq
    )
    C = jg.snv_contribution_table()
    expand, cdb32, qual_bin = jg.hist_tables(nq, qlv, C)
    het, minq = np.float64(0.001), np.int32(40)
    jargs = (st, np.int32(w0s), colg, res_idx, res_pred, np.int32(len(res_idx)),
             pk, ref, C, expand, cdb32, qual_bin, het, minq)
    kw = dict(window=window, nq=nq, lanes=lanes)
    j_exact = jg.genotype_window_hist_resolve_batch(
        [((jargs, dict(kw, exact_f64=True)), jg.genotype_window_hist(*jargs, **kw, exact_f64=True))]
    )[0]
    j_def = jg.genotype_window_hist_resolve_batch(
        [((jargs, kw), jg.genotype_window_hist(*jargs, **kw))]
    )[0]
    t = tg.genotype_window_hist_resolve_batch([
        tg.genotype_window_hist(
            T(st), w0s, T(colg), T(res_idx.astype(np.int64)), T(res_pred),
            T(pk), T(ref), T(C), T(expand.astype(np.float64)), T(cdb32),
            T(qual_bin.astype(np.int64)), float(het), int(minq), **kw,
        )
    ])[0]
    k = int(t["n_sites"])
    assert k > 10
    for j in (j_exact, j_def):
        assert int(j["n_sites"]) == k
        assert int(j["n_flagged"]) == int(t["n_flagged"])
        for f in ("site_idx", "bi", "bj", "gq", "total", "strand_counts"):
            assert np.array_equal(np.asarray(t[f]), np.asarray(j[f])[:k]), f
        assert np.array_equal(np.asarray(t["depths"]), np.asarray(j["depths"])[:k])
    for f in ("logcond", "ref_prob"):
        a, b = np.asarray(t[f]), np.asarray(j_exact[f])[:k]
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)
        np.testing.assert_allclose(a, np.asarray(j_def[f])[:k], rtol=0, atol=1e-4)
