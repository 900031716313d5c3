"""ngsepcore_tpu_torch tier-3 DP against the JAX package on the CPU.

The port's plain Gotoh forward (kernels/pairwise_cuda.gotoh_forward_plane_ref,
what the CUDA kernel is held to on the card) must be bit-identical to the
Pallas kernel run in interpret mode.  Plane mask: cells of rows 1..qlen[b]
and columns 1..slen[b]; past qlen the reference freezes M/I/D and the run
carries but not the D-run fields, so other cells hold values the walk never
reads.  Run-jump walk, stats and device left-align outputs must be equal.
"""
import numpy as np
import pytest
import torch

from ngsepcore_tpu.kernels import pairwise as jpw
from ngsepcore_tpu.kernels.pairwise_pallas import gotoh_forward_plane_pallas
from ngsepcore_tpu_torch.kernels import pairwise as tpw
from ngsepcore_tpu_torch.kernels.pairwise_cuda import (
    CLUSTER_MAX_LS,
    SEG_MAX_LS,
    cluster_layout,
    cluster_shape,
    gotoh_forward_plane,
    gotoh_forward_plane_cluster,
    gotoh_forward_plane_ref,
    kernel_for,
    seg_layout,
    wide_layout,
)

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

T = torch.from_numpy


def _noisy(rng, B, Lq, Ls):
    """Queries embedded in subjects with a few indels (the generator of
    tests/test_pairwise_pallas.py)."""
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    s = rng.integers(0, 4, (B, Ls)).astype(np.int8)
    for b in range(B):
        off = int(rng.integers(0, max(1, Ls - Lq - 5)))
        piece = list(q[b][: Lq - 6])
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(1, len(piece) - 1))
            if rng.random() < 0.5:
                piece.insert(p, int(rng.integers(0, 4)))
            else:
                del piece[p]
        piece = np.array(piece[: Ls - off], np.int8)
        s[b, off : off + len(piece)] = piece
    ql = rng.integers(Lq // 2, Lq + 1, B).astype(np.int32)
    sl = rng.integers(int(Ls * 0.8), Ls + 1, B).astype(np.int32)
    return q, ql, s, sl


def _plane_mask(Lq, Ls, ql, sl):
    rows = np.arange(1, Lq + 1)[:, None, None]
    cols = np.arange(1, Ls + 1)[None, None, :]
    return (rows <= ql[None, :, None]) & (cols <= sl[None, :, None])


@pytest.mark.parametrize(
    "cfg",
    [
        dict(free_start2=True, free_end2=True),
        dict(free_start2=False, free_end2=False),
        dict(free_start2=True, free_end2=False),
    ],
)
def test_gotoh_plane_ref_matches_pallas(cfg):
    rng = np.random.default_rng(13)
    B, Lq, Ls = 256, 48, 128
    q, ql, s, sl = _noisy(rng, B, Lq, Ls)
    jplane, jscore, jend_j, jstart_k = gotoh_forward_plane_pallas(
        q, ql, s, sl, interpret=True, **cfg
    )
    plane, score, end_i, end_j, start_k = gotoh_forward_plane_ref(
        T(q), T(ql), T(s), T(sl), **cfg
    )
    mask = _plane_mask(Lq, Ls, ql, sl)
    jp = np.asarray(jplane).view(np.int32)
    assert np.array_equal(plane.numpy()[mask], jp[mask])
    assert np.array_equal(score.numpy(), np.asarray(jscore))
    assert np.array_equal(end_j.numpy(), np.asarray(jend_j))
    assert np.array_equal(start_k.numpy(), np.asarray(jstart_k))
    assert np.array_equal(end_i.numpy(), ql)
    # the CPU wrapper takes the plain version and launches nothing
    before = gotoh_forward_plane.launches
    w = gotoh_forward_plane(T(q), T(ql), T(s), T(sl), **cfg)
    assert gotoh_forward_plane.launches == before
    assert all(torch.equal(a, b) for a, b in zip(w, (plane, score, end_i, end_j, start_k)))


def _to_np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _assert_runs_equal(t, j):
    for k in ("score", "rop", "rlen", "n_runs", "n_ops", "start_j", "end_j", "end_i", "walk_ok"):
        assert np.array_equal(t[k].numpy(), j[k]), k


@pytest.mark.parametrize(
    "cfg",
    [
        # tier-2 STR left flank and right flank (align/str_tier2.py)
        dict(free_start1=False, free_end1=True, free_start2=True, free_end2=False),
        dict(free_start1=True, free_end1=False, free_start2=False, free_end2=True),
    ],
)
def test_runs_tier2_configs_match_jax(cfg):
    rng = np.random.default_rng(5)
    q, ql, s, sl = _noisy(rng, 128, 40, 64)
    j = _to_np(jpw.affine_gap_align_runs(q, ql, s, sl, **cfg))
    t = tpw.affine_gap_align_runs(T(q), T(ql), T(s), T(sl), **cfg)
    _assert_runs_equal(t, j)


def _gapped_jobs(rng, n, Lq=64, Ls=96):
    """Homopolymer-rich subjects with reads carrying 0-3 indels, so the
    device left-align shifts gap runs (tests/test_device_left_align.py)."""
    qc = np.full((n, Lq), 4, np.int8)
    sc = np.full((n, Ls), 4, np.int8)
    ql = np.zeros(n, np.int32)
    sl = np.zeros(n, np.int32)
    for i in range(n):
        slen = int(rng.integers(70, Ls))
        s = []
        while len(s) < slen:
            s.extend([int(rng.integers(0, 4))] * int(rng.integers(1, 6)))
        s = np.array(s[:slen], np.int8)
        off = int(rng.integers(0, 8))
        read = list(s[off : off + 52])
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(1, max(2, len(read) - 2)))
            ln = int(rng.integers(1, 5))
            if rng.random() < 0.5:
                read[p:p] = [int(rng.integers(0, 4))] * ln
            else:
                del read[p : p + ln]
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, len(read)))
            read[p] = int(rng.integers(0, 4))
        read = read[:Lq]
        qc[i, : len(read)] = read
        ql[i] = len(read)
        sc[i, :slen] = s
        sl[i] = slen
    return qc, ql, sc, sl


def test_runs_stats_left_align_match_jax():
    """affine_gap_align_runs -> dp_stats_runs (-> _left_align_rle) on the
    tier-3 configuration: every output equal."""
    rng = np.random.default_rng(7)
    q, ql, s, sl = _gapped_jobs(rng, 384)
    jout = jpw.affine_gap_align_runs(q, ql, s, sl, free_start2=True, free_end2=True)
    jst = _to_np(jpw.dp_stats_runs(jout, q, s))
    tout = tpw.affine_gap_align_runs(T(q), T(ql), T(s), T(sl))
    _assert_runs_equal(tout, _to_np(jout))
    tst = tpw.dp_stats_runs(tout, T(q), T(s))
    for k in jst:
        assert np.array_equal(tst[k].numpy(), jst[k]), k
    assert jst["has_gap"].sum() > 50  # the workload exercises gapped rows
    rlen_j, fb_j = jpw._left_align_rle(
        jout["rop"], jout["rlen"], jout["n_runs"], jout["start_j"], q, s
    )
    rlen_t, fb_t = tpw._left_align_rle(
        tout["rop"], tout["rlen"], tout["n_runs"], tout["start_j"], T(q), T(s)
    )
    assert np.array_equal(rlen_t.numpy(), np.asarray(rlen_j))
    assert np.array_equal(fb_t.numpy(), np.asarray(fb_j))


def test_dp_run_all_matches_jax():
    """Device-gathered tier-3 sweep over a packed read matrix and genome."""
    rng = np.random.default_rng(11)
    G = 5000
    concat = rng.integers(0, 4, G).astype(np.int8)
    R, Lp, n = 300, 112, 200
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
    rows = rng.choice(R, n, replace=False).astype(np.int32)
    firsts = np.maximum(starts[rows] - 3, 0).astype(np.int32)
    slen = (lengths[rows] + 6).astype(np.int32)
    strand = strand_r[rows]
    CH, Lq, Ls, n_chunks = 128, 112, 128, 2
    pad = CH * n_chunks

    def padded(a, dt):
        out = np.zeros(pad, dt)
        out[:n] = a
        return out

    args = [padded(rows, np.int32), padded(strand, np.int32),
            padded(firsts, np.int32), padded(slen, np.int32)]
    j = jpw.dp_run_all(bigpq, lengths, concat, *args,
                       CH=CH, Lq=Lq, Ls=Ls, n_chunks=n_chunks)
    targs = [T(args[0].astype(np.int64)), T(args[1]), T(args[2].astype(np.int64)), T(args[3])]
    t = tpw.dp_run_all(T(bigpq), T(lengths), T(concat), *targs,
                       CH=CH, Lq=Lq, Ls=Ls, n_chunks=n_chunks)
    for k in j:
        assert np.array_equal(t[k].numpy(), np.asarray(j[k])), k
    qj, lj, sj = jpw.dp_gather_inputs(
        bigpq, lengths, concat, *args[:3], args[3], Lq=Lq, Ls=Ls
    )
    qt, lt, st = tpw.dp_gather_inputs(
        T(bigpq), T(lengths), T(concat), *targs[:3], targs[3], Lq=Lq, Ls=Ls
    )
    for a, b in ((qt, qj), (lt, lj), (st, sj)):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# edge shapes of the forward pass against the JAX package

_CFGS = [
    dict(free_start2=True, free_end2=True),
    dict(free_start2=False, free_end2=False),
    dict(free_start2=True, free_end2=False),
]
_CFG_IDS = ["free-free", "global", "free_start"]


def _edge_case(name):
    """Inputs at shapes the Pallas kernel accepts (B % 256 == 0,
    Ls % 128 == 0) that are edges for the CUDA kernels."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ls256":  # widest subject the warp-per-alignment kernel takes
        return _noisy(rng, 256, 24, 256)
    if name == "ls512":  # a width of the block-per-alignment kernel
        return _noisy(rng, 256, 12, 512)
    if name == "lq1":
        q, ql, s, sl = _noisy(rng, 256, 16, 128)
        return q[:, :1].copy(), np.ones(256, np.int32), s, sl
    if name == "qlen0":  # rows frozen from the first query row on
        q, ql, s, sl = _noisy(rng, 256, 16, 128)
        ql[::3] = 0
        sl[::5] = 0
        return q, ql, s, sl
    if name == "allN":  # N matches N
        q, ql, s, sl = _noisy(rng, 256, 16, 128)
        q[:] = 4
        s[:] = 4
        return q, ql, s, sl
    raise KeyError(name)


@pytest.mark.parametrize("cfg", _CFGS, ids=_CFG_IDS)
@pytest.mark.parametrize("name", ["ls256", "ls512", "lq1", "qlen0", "allN"])
def test_gotoh_plane_ref_edge_shapes_match_pallas(name, cfg):
    """Integer outputs identical (tolerance 0); the plane on the cells the
    Pallas kernel defines (rows <= qlen, columns <= slen)."""
    q, ql, s, sl = _edge_case(name)
    jplane, jscore, jend_j, jstart_k = gotoh_forward_plane_pallas(
        q, ql, s, sl, interpret=True, **cfg
    )
    plane, score, end_i, end_j, start_k = gotoh_forward_plane_ref(
        T(q), T(ql), T(s), T(sl), **cfg
    )
    mask = _plane_mask(q.shape[1], s.shape[1], ql, sl)
    jp = np.asarray(jplane).view(np.int32)
    assert np.array_equal(plane.numpy()[mask], jp[mask])
    # an empty query or subject: the Pallas kernel leaves column 0 out of
    # the best-column search and breaks an all-banned tie at column 0; the
    # XLA scan, which the port follows, counts column 0 and takes the
    # largest column (test_runs_edge_shapes_match_jax_scan has such rows)
    rows = (ql > 0) & (sl > 0)
    assert rows.sum() >= 130
    assert np.array_equal(score.numpy()[rows], np.asarray(jscore)[rows])
    assert np.array_equal(end_j.numpy()[rows], np.asarray(jend_j)[rows])
    assert np.array_equal(start_k.numpy()[rows], np.asarray(jstart_k)[rows])
    assert np.array_equal(end_i.numpy(), ql)


@pytest.mark.parametrize("cfg", _CFGS, ids=_CFG_IDS)
@pytest.mark.parametrize(
    "B,Lq,Ls", [(1, 20, 33), (5, 12, 1), (7, 1, 40), (3, 30, 33)],
    ids=["B1-Ls33", "Ls1", "Lq1", "B3-Ls33"],
)
def test_runs_edge_shapes_match_jax_scan(B, Lq, Ls, cfg):
    """Shapes the Pallas kernel does not take (odd B, Ls 1 and 33) against
    the JAX package's XLA scan, through the run-jump walk."""
    rng = np.random.default_rng(B * 100 + Ls)
    q = rng.integers(0, 5, (B, Lq)).astype(np.int8)
    s = rng.integers(0, 5, (B, Ls)).astype(np.int8)
    w = min(Lq, Ls)
    s[:, :w] = np.where(rng.random((B, w)) < 0.2, s[:, :w], q[:, :w])
    ql = rng.integers(0, Lq + 1, B).astype(np.int32)
    sl = rng.integers(0, Ls + 1, B).astype(np.int32)
    ql[0], sl[0] = Lq, Ls
    j = _to_np(jpw.affine_gap_align_runs(q, ql, s, sl, **cfg))
    t = tpw.affine_gap_align_runs(T(q), T(ql), T(s), T(sl), **cfg)
    _assert_runs_equal(t, j)


# ---------------------------------------------------------------------------
# the decomposition the warp-per-alignment CUDA kernel relies on, in torch

I32_MIN = -(2**31)


def _shfl_up(v, o):
    """__shfl_up_sync along the lane axis (dim 1): lanes below the offset
    keep their own value."""
    out = v.clone()
    out[:, o:] = v[:, :-o]
    return out


def _warp_excl_max(v, seed):
    """csrc/gotoh_forward.cu:warp_excl_max on (B, 32): lane l gets
    max(seed, v[0..l-1])."""
    for o in (1, 2, 4, 8, 16):
        v = torch.maximum(v, _shfl_up(v, o))
    up = _shfl_up(v, 1)
    out = torch.maximum(up, seed[:, None])
    out[:, 0] = seed
    return out


def _blocked_excl_max(x, seed, K, ownership):
    """Exclusive running max of x (B, 32*K) seeded with seed (B,), computed
    as a lane does: a pass over the lane's own columns, a warp scan of the
    lane totals, the prefix applied."""
    B = x.shape[0]
    if ownership == "contiguous":  # lane l owns columns l*K .. l*K+K-1
        v = x.reshape(B, 32, K)
        run = torch.cummax(v, dim=2).values  # the sequential pass
        pre = _warp_excl_max(run[:, :, K - 1], seed)
        left = torch.cat([pre[:, :, None],
                          torch.maximum(pre[:, :, None], run[:, :, :-1])], dim=2)
        return left.reshape(B, 32 * K)
    # interleaved: lane l owns columns l + 32*k; one warp scan per k, the
    # total of slab k carried into slab k+1
    v = x.reshape(B, K, 32)
    out = []
    carry = seed
    for k in range(K):
        out.append(_warp_excl_max(v[:, k], carry))
        carry = torch.maximum(carry, v[:, k].amax(dim=1))
    return torch.stack(out, dim=1).reshape(B, 32 * K)


@pytest.mark.parametrize("ownership", ["contiguous", "interleaved"])
@pytest.mark.parametrize("Ls", [1, 33, 160, 192, 256])
def test_blocked_max_scan_equals_cummax(Ls, ownership):
    rng = np.random.default_rng(Ls)
    B, K = 64, (Ls + 31) // 32
    x = torch.full((B, 32 * K), I32_MIN, dtype=torch.int32)
    # few distinct values: ties and long flat stretches
    x[:, :Ls] = T(rng.integers(-6, 6, (B, Ls)).astype(np.int32))
    seed = T(rng.integers(-8, 4, B).astype(np.int32))
    want = torch.cummax(torch.cat([seed[:, None], x], dim=1), dim=1).values[:, :-1]
    got = _blocked_excl_max(x, seed, K, ownership)
    assert torch.equal(got[:, :Ls], want[:, :Ls])


def _warp_kernel_model(q, ql, s, sl, *, match=1, mismatch=1, open_gap=3,
                       ext_gap=1, free_start1=False, free_end1=False,
                       free_start2=True, free_end2=True):
    """gotoh_forward_warp_kernel<K, kFreeStart1, kFreeEnd1> of csrc/gotoh_forward.cu,
    statement by statement on (B, 32, K) tensors: lane-contiguous columns,
    the run carries as the masked previous plane word (cwm = sm | em<<8,
    cwi = si<<2 | ei<<16), the diagonal hand-off, the two blocked
    exclusive max-scans, the uncommitted rows past qlen, the free query
    start (column 0 of I is 0) and the free query end (the owner of column
    slen keeps a running best M and its row).  Returns (plane, score,
    end_j, start_k, end_i)."""
    i32 = torch.int32
    B, Lq = q.shape
    Ls = s.shape[1]
    K = (Ls + 31) // 32
    W = 32 * K
    NEG = -(10**7)
    c = torch.arange(1, W + 1, dtype=i32)[None, :].expand(B, W)
    s_ch = torch.zeros((B, W), dtype=i32)
    s_ch[:, :Ls] = s.to(i32)
    m = torch.full((B, W), NEG, dtype=i32)
    i = m.clone()
    d = torch.zeros((B, W), dtype=i32) if free_start2 else (
        -open_gap - ext_gap * (c - 1)).to(i32)
    cwm = torch.zeros((B, W), dtype=i32)
    cwi = torch.zeros((B, W), dtype=i32)
    m0 = torch.zeros(B, dtype=i32)
    i0 = m0.clone()
    d0 = m0.clone()
    plane = torch.empty((Lq, B, Ls), dtype=i32)
    sl = sl.to(i32)
    best = torch.where(sl == 0, 0, NEG).to(i32)
    brow = torch.where(sl == 0, 0, Lq).to(i32)
    own = (sl.long() - 1).clamp(min=0)[:, None]  # column slen, 0-based

    def diag_out(m, i, d, cwm):
        i_ge_d = i >= d
        mx = torch.maximum(i, d)
        m_ge = m >= mx
        hd = torch.maximum(m, mx)
        grown = torch.minimum(cwm + 0x100, cwm | 0xFF00)
        alt = torch.where(i_ge_d, 0x101, 0x102).to(i32)
        return hd, torch.where(m_ge, grown, alt)

    def shift_in(x, x0):  # column c takes column c-1's value, column 1 x0
        return torch.cat([x0[:, None], x[:, :-1]], dim=1)

    for r in range(1, Lq + 1):
        qc = q[:, r - 1].to(i32)[:, None]
        active = (r <= ql)[:, None]
        i0n = 0 if free_start1 else -open_gap - ext_gap * (r - 1)
        am0 = NEG - open_gap
        ai0 = i0n - open_gap
        a0 = max(am0, ai0)
        hd, mw = diag_out(m, i, d, cwm)
        hd0, mw0 = diag_out(m0, i0, d0, torch.zeros(B, dtype=i32))
        hd_in, mw_in = shift_in(hd, hd0), shift_in(mw, mw0)
        m_row = hd_in + torch.where(s_ch == qc, match, -mismatch).to(i32)
        cm, ci, cd = m - open_gap, i - ext_gap, d - open_gap
        ci_ge_cd = ci >= cd
        mx = torch.maximum(ci, cd)
        cm_ge = cm >= mx
        i_row = torch.maximum(cm, mx)
        grown = torch.minimum(cwi + 0x10000, cwi | 0xFF0000)
        cwi_row = torch.where(
            cm_ge, 0x10000, torch.where(ci_ge_cd, grown, 0x10008)
        ).to(i32)
        m_ge_i = m_row >= i_row
        a = torch.maximum(m_row, i_row) - open_gap
        y = a + ext_gap * c
        seed = torch.full((B,), a0, dtype=i32)
        left = _blocked_excl_max(y, seed, K, "contiguous")
        d_row = left - ext_gap * (c - 1)
        z = torch.where(
            y >= left, (c + 1) * 4 + torch.where(m_ge_i, 0, 1), -1
        ).to(i32)
        z0 = (4 + (0 if am0 >= ai0 else 1)) if a0 >= NEG - ext_gap else -1
        zseed = torch.full((B,), max(z0, 0), dtype=i32)
        orun = _blocked_excl_max(z, zseed, K, "contiguous")
        m = torch.where(active, m_row, m)
        i = torch.where(active, i_row, i)
        d = torch.where(active, d_row, d)
        cwm = torch.where(active, mw_in, cwm)
        cwi = torch.where(active, cwi_row, cwi)
        m0 = torch.where(active[:, 0], NEG, m0).to(i32)
        i0 = torch.where(active[:, 0], i0n, i0).to(i32)
        d0 = torch.where(active[:, 0], NEG, d0).to(i32)
        if free_end1:
            at = m.gather(1, own)[:, 0]
            upd = active[:, 0] & (sl >= 1) & (at >= best)
            best = torch.where(upd, at, best)
            brow = torch.where(upd, r, brow).to(i32)
        sd = orun & 3
        ed = torch.clamp(c - (orun >> 2) + 1, max=255)
        plane[r - 1] = (cwm | cwi | (sd << 4) | (ed << 24))[:, :Ls]

    zeros = torch.zeros(B, dtype=i32)
    if free_end1:
        return plane, best, sl, zeros, brow
    if free_end2:
        key = torch.where(c <= sl[:, None], m, NEG).long() * (1 << 32) + c
        key = key[:, :Ls]
        key0 = m0.long() * (1 << 32)
        best = torch.maximum(key.amax(dim=1), key0)
        end_j = best & 0xFFFFFFFF
        score = (best - end_j) // (1 << 32)
        return plane, score.to(i32), end_j.to(i32), zeros, ql.to(i32)
    sc = sl.clamp(0, Ls).long()[:, None]
    pick = lambda x, x0: torch.cat([x0[:, None], x], dim=1).gather(1, sc)[:, 0]
    mc, ic, dc = pick(m, m0), pick(i, i0), pick(d, d0)
    score = torch.where(ic > mc, ic, mc)
    sk = torch.where(ic > mc, 1, 0)
    score = torch.where(dc > score, dc, score)
    sk = torch.where(dc > torch.maximum(mc, ic), 2, sk)
    return plane, score, sl, sk.to(i32), ql.to(i32)


@pytest.mark.parametrize("cfg", _CFGS, ids=_CFG_IDS)
@pytest.mark.parametrize(
    "B,Lq,Ls", [(48, 40, 64), (16, 24, 33), (6, 300, 260), (8, 6, 1), (6, 1, 70)],
    ids=["ragged", "Ls33", "saturating-runs", "Ls1", "Lq1"],
)
def test_warp_kernel_decomposition_reproduces_plain_plane(B, Lq, Ls, cfg):
    """Full plane (rows past qlen and columns past slen included) and the
    final vectors, on ragged qlen with some qlen = 0 and N runs."""
    rng = np.random.default_rng(B + Lq + Ls)
    if Lq >= 16 and Ls >= Lq + 12:
        q, ql, s, sl = _noisy(rng, B, Lq, Ls)
    else:
        q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
        s = rng.integers(0, 4, (B, Ls)).astype(np.int8)
        ql = rng.integers(0, Lq + 1, B).astype(np.int32)
        sl = rng.integers(0, Ls + 1, B).astype(np.int32)
    if Lq >= 300:  # M and I runs longer than the 8-bit saturation
        q[0] = 1
        s[0] = 1
        ql[0], sl[0] = Lq, Ls
        q[1] = 4
        ql[1] = Lq
    ql[-1] = 0
    q[2, Lq // 2 :] = 4
    s[2, Ls // 2 :] = 4
    want = gotoh_forward_plane_ref(T(q), T(ql), T(s), T(sl), **cfg)
    got = _warp_kernel_model(T(q), T(ql), T(s), T(sl), **cfg)
    if Lq >= 300:
        # em and ei reach their 8-bit ceiling; ed where row 0 is not free
        for shift in (8, 16) if cfg["free_start2"] else (8, 16, 24):
            assert int(((want[0] >> shift) & 255).max()) == 255
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[3])
    assert torch.equal(got[3], want[4])


# ---------------------------------------------------------------------------
# the wide kernel (Ls > 1024): contiguous columns per thread, state in scratch

def _warp_incl_max(v):
    """csrc/gotoh_forward.cu:warp_incl_max on (..., 32): the lane >= o guard."""
    for o in (1, 2, 4, 8, 16):
        up = v.clone()
        up[..., o:] = v[..., :-o]
        lane = torch.arange(32)
        v = torch.where(lane >= o, torch.maximum(v, up), v)
    return v


def _block_excl_max(v, seed):
    """csrc/gotoh_forward.cu:block_excl_max on (B, T), T a multiple of 32:
    warp scans, a warp scan of the warp totals (padded with INT_MIN), the
    left lane's warp-inclusive value by shuffle (none for lane 0) with the
    earlier warps' total, then the seed."""
    B, T = v.shape
    nw = T // 32
    w = _warp_incl_max(v.reshape(B, nw, 32))
    tot = torch.full((B, 32), I32_MIN, dtype=torch.int32)
    tot[:, :nw] = w[:, :, 31]
    tot = _warp_incl_max(tot)
    up = w.clone()
    up[:, :, 1:] = w[:, :, :-1]  # __shfl_up_sync by 1; lane 0 takes none
    up[:, :, 0] = I32_MIN
    prefix = torch.full((B, nw, 1), I32_MIN, dtype=torch.int32)  # earlier warps
    prefix[:, 1:, 0] = tot[:, : nw - 1]
    ex = torch.maximum(up, prefix).reshape(B, T)
    return torch.maximum(ex, torch.tensor(seed, dtype=torch.int32))


def _wide_kernel_model(q, ql, s, sl, *, match=1, mismatch=1, open_gap=3,
                       ext_gap=1, free_start1=False, free_end1=False,
                       free_start2=True, free_end2=True):
    """gotoh_forward_wide_kernel<kFreeStart1, kFreeEnd1> of
    csrc/gotoh_forward.cu, statement by statement on (B, T) tensors, one
    entry a thread: thread t owns the C contiguous columns t*C+1 .. t*C+C
    (wide_layout), their state is the scratch fields (M, I, D, CW = cwm |
    cwi; the row's NM, NI, NCW, Y), the last owned column's diagonal
    hand-off goes to the right neighbour, and the row is three sequential
    passes over the owned columns around two block scans of the thread
    totals (block_excl_max).  Returns (plane, score, end_j, start_k, end_i)."""
    i32 = torch.int32
    B, Lq = q.shape
    Ls = s.shape[1]
    C, T = wide_layout(Ls)
    NEG = -(10**7)
    CWM, CWI = 0xFF03, 0xFF000C
    c0 = torch.arange(T, dtype=i32)[None, :] * C + 1  # (1, T)
    s_ch = torch.zeros((B, T * C), dtype=i32)
    s_ch[:, :Ls] = s.to(i32)
    s_ch = s_ch.reshape(B, T, C)
    full = lambda v: torch.full((B, T), v, dtype=i32)
    M = [full(NEG) for _ in range(C)]
    I = [full(NEG) for _ in range(C)]
    D = [full(0) if free_start2 else (-open_gap - ext_gap * (c0 + k - 1)).expand(B, T).to(i32)
         for k in range(C)]
    CW = [full(0) for _ in range(C)]
    NM, NI, NCW, Y = ([None] * C for _ in range(4))
    m0 = i0 = d0 = torch.zeros(B, dtype=i32)
    sl = sl.to(i32)
    best = torch.where(sl == 0, 0, NEG).to(i32)
    brow = torch.where(sl == 0, 0, Lq).to(i32)
    plane = torch.empty((Lq, B, T * C), dtype=i32)

    def diag_out(m, i, d, cwm):
        i_ge_d = i >= d
        mx = torch.maximum(i, d)
        m_ge = m >= mx
        grown = torch.minimum(cwm + 0x100, cwm | 0xFF00)
        return torch.maximum(m, mx), torch.where(m_ge, grown, torch.where(i_ge_d, 0x101, 0x102)).to(i32)

    for r in range(1, Lq + 1):
        qc = q[:, r - 1].to(i32)[:, None]
        active = (r <= ql)[:, None]
        i0n = 0 if free_start1 else -open_gap - ext_gap * (r - 1)
        am0 = NEG - open_gap
        ai0 = i0n - open_gap
        a0 = max(am0, ai0)
        # diagonal hand-off from the left neighbour (block_from_left)
        hd_l, mw_l = diag_out(M[C - 1], I[C - 1], D[C - 1], CW[C - 1] & CWM)
        hd00, mw00 = diag_out(m0, i0, d0, torch.zeros(B, dtype=i32))
        hd_in = torch.cat([hd00[:, None], hd_l[:, :-1]], dim=1)
        mw_in = torch.cat([mw00[:, None], mw_l[:, :-1]], dim=1)
        # pass 1
        run = full(I32_MIN)
        for k in range(C):
            c = c0 + k
            m, i, d, cw = M[k], I[k], D[k], CW[k]
            m_row = hd_in + torch.where(s_ch[:, :, k] == qc, match, -mismatch).to(i32)
            cm, ci, cd = m - open_gap, i - ext_gap, d - open_gap
            ci_ge_cd = ci >= cd
            mx = torch.maximum(ci, cd)
            cm_ge = cm >= mx
            i_row = torch.maximum(cm, mx)
            cwi = cw & CWI
            grown = torch.minimum(cwi + 0x10000, cwi | 0xFF0000)
            cwi_row = torch.where(cm_ge, 0x10000, torch.where(ci_ge_cd, grown, 0x10008)).to(i32)
            y = torch.maximum(m_row, i_row) - open_gap + ext_gap * c
            run = torch.maximum(run, y)
            NM[k], NI[k], NCW[k], Y[k] = m_row, i_row, mw_in | cwi_row, y
            hd_in, mw_in = diag_out(m, i, d, cw & CWM)
        pre = _block_excl_max(run, a0)
        # pass 2
        zr, left = full(-1), pre
        for k in range(C):
            z = torch.where(Y[k] >= left, (c0 + k + 1) * 4 + torch.where(NM[k] >= NI[k], 0, 1), -1)
            zr = torch.maximum(zr, z.to(i32))
            left = torch.maximum(left, Y[k])
        z0 = (4 + (0 if am0 >= ai0 else 1)) if a0 >= NEG - ext_gap else -1
        zpre = _block_excl_max(zr, max(z0, 0))
        # pass 3
        left, orun = pre, zpre
        for k in range(C):
            c = c0 + k
            d_row = left - ext_gap * (c - 1)
            z = torch.where(Y[k] >= left, (c + 1) * 4 + torch.where(NM[k] >= NI[k], 0, 1), -1).to(i32)
            sd = orun & 3
            ed = torch.clamp(c - (orun >> 2) + 1, max=255)
            cw = torch.where(active, NCW[k], CW[k])
            plane[r - 1, :, k::C] = cw | (sd << 4) | (ed << 24)
            if free_end1:
                upd = active & (c == sl[:, None]) & (NM[k] >= best[:, None])
                hit = upd.any(dim=1)
                best = torch.where(hit, NM[k].masked_fill(~upd, I32_MIN).amax(dim=1), best)
                brow = torch.where(hit, r, brow).to(i32)
            M[k] = torch.where(active, NM[k], M[k])
            I[k] = torch.where(active, NI[k], I[k])
            D[k] = torch.where(active, d_row, D[k])
            CW[k] = torch.where(active, NCW[k], CW[k])
            left = torch.maximum(left, Y[k])
            orun = torch.maximum(orun, z)
        m0 = torch.where(active[:, 0], NEG, m0).to(i32)
        i0 = torch.where(active[:, 0], i0n, i0).to(i32)
        d0 = torch.where(active[:, 0], NEG, d0).to(i32)

    plane = plane[:, :, :Ls]  # column t*C+k+1 sits at index k + C*t above
    cols = lambda X: torch.stack(X, dim=2).reshape(B, T * C)  # (B, T, C) -> columns
    m, i, d = cols(M), cols(I), cols(D)
    zeros = torch.zeros(B, dtype=i32)
    if free_end1:
        return plane, best, sl, zeros, brow
    c = torch.arange(1, T * C + 1)[None, :]
    if free_end2:
        key = torch.where(c <= sl[:, None], m, NEG).long() * (1 << 32) + c
        best = torch.maximum(key[:, :Ls].amax(dim=1), m0.long() * (1 << 32))
        end_j = best & 0xFFFFFFFF
        return plane, ((best - end_j) // (1 << 32)).to(i32), end_j.to(i32), zeros, ql.to(i32)
    sc = sl.clamp(0, Ls).long()[:, None]
    pick = lambda x, x0: torch.cat([x0[:, None], x], dim=1).gather(1, sc)[:, 0]
    mc, ic, dc = pick(m, m0), pick(i, i0), pick(d, d0)
    score = torch.where(ic > mc, ic, mc)
    sk = torch.where(ic > mc, 1, 0)
    score = torch.where(dc > score, dc, score)
    sk = torch.where(dc > torch.maximum(mc, ic), 2, sk)
    return plane, score, sl, sk.to(i32), ql.to(i32)


_WIDE_CFGS = _CFGS + [
    dict(free_start1=False, free_end1=True, free_start2=True, free_end2=False),
    dict(free_start1=True, free_end1=False, free_start2=False, free_end2=True),
]
_WIDE_CFG_IDS = _CFG_IDS + ["tier2-left", "tier2-right"]


@pytest.mark.parametrize("cfg", _WIDE_CFGS, ids=_WIDE_CFG_IDS)
@pytest.mark.parametrize(
    "B,Lq,Ls", [(5, 30, 1025), (3, 24, 2100), (4, 300, 1100), (6, 20, 300)],
    ids=["Ls1025", "Ls2100-C3", "saturating-runs", "Ls300-C1"],
)
def test_wide_kernel_decomposition_reproduces_plain_plane(B, Lq, Ls, cfg):
    """Full plane and final vectors of the wide kernel's model against the
    plain version: ragged qlen with qlen 0, N runs, slen 0, runs past 255."""
    rng = np.random.default_rng(B * 7 + Lq + Ls)
    q, ql, s, sl = _noisy(rng, B, Lq, Ls)
    if Lq >= 300:  # M and I runs longer than the 8-bit saturation
        q[0] = 1
        s[0] = 1
        ql[0], sl[0] = Lq, Ls
        q[1] = 4
        ql[1] = Lq
    ql[-1] = 0
    sl[-2] = 0
    q[2, Lq // 2 :] = 4
    s[2, Ls // 2 :] = 4
    want = gotoh_forward_plane_ref(T(q), T(ql), T(s), T(sl), **cfg)
    got = _wide_kernel_model(T(q), T(ql), T(s), T(sl), **cfg)
    if Lq >= 300:
        assert int(((want[0] >> 8) & 255).max()) == 255
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[3])
    assert torch.equal(got[3], want[4])
    assert torch.equal(got[4], want[2])


# ---------------------------------------------------------------------------
# the seg kernel (256 < Ls <= SEG_MAX_LS): the warp kernel's row split over
# W warps, pipelined along the rows

def _diag_out(m, i, d, cwm):
    """csrc/gotoh_forward.cu:diag_out: max(M, I, D) and the diagonal
    successor's M fields."""
    i_ge_d = i >= d
    mx = torch.maximum(i, d)
    grown = torch.minimum(cwm + 0x100, cwm | 0xFF00)
    alt = torch.where(i_ge_d, 0x101, 0x102)
    return torch.maximum(m, mx), torch.where(m >= mx, grown, alt).to(torch.int32)


def _warp_scan_max(v):
    """csrc/gotoh_forward.cu:warp_scan_max on (B, 32): inclusive max over
    the lanes, __shfl_up_sync handing the low lanes their own value back."""
    for o in (1, 2, 4, 8, 16):
        v = torch.maximum(v, _shfl_up(v, o))
    return v


def _excl_from_incl(incl, seed):
    """csrc/gotoh_forward.cu:excl_from_incl: lane l gets max(seed,
    incl[l-1]), lane 0 the seed."""
    out = torch.maximum(_shfl_up(incl, 1), seed[:, None])
    out[:, 0] = seed
    return out


def _seg_kernel_model(q, ql, s, sl, *, K=None, W=None, ctas=1, match=1, mismatch=1,
                      open_gap=3, ext_gap=1, free_start1=False, free_end1=False,
                      free_start2=True, free_end2=True):
    """gotoh_forward_seg_kernel<K, kFreeStart1, kFreeEnd1> of
    csrc/gotoh_forward.cu on (B, 32, K) tensors a warp: warp w owns columns
    w*32K+1 .. (w+1)*32K, lane l of it K contiguous ones (seg_layout, or
    the K and W given).  A warp computes row r from its own registers, the
    query code and warp w-1's message for row r, read before the row: the
    inclusive maxima of y and of the packed D-run source z over every
    column to its left (seeded by column 0's a0 and max(z0, 0)), written
    after warp w-1's row r, and the diagonal hand-off (hd, mw) of warp
    w-1's last column, written after its row r-1 (row 1's: that column's
    initial state).  It runs in skewed order, step t taking warp w on row
    t - w and the warps from the last to the first, so no message is read
    in the step that wrote it; a ring of RING rows a boundary bounds the
    rows in flight.

    ctas > 1 models gotoh_forward_cluster_kernel: one chain of ctas * W
    warps over the blocks of a cluster, W a block.  A message across a
    block boundary carries the same four ints (the kernel writes it into
    the receiving block's shared memory), warps past the row's end (only
    in the last block) sit the rows out, and with a free subject end each
    block reduces its warps' best (value, column) keys and block 0 reduces
    the blocks'.  Returns (plane, score, end_j, start_k, end_i)."""
    i32 = torch.int32
    B, Lq = q.shape
    Ls = s.shape[1]
    if K is None:
        K, W = seg_layout(Ls, free_end1)
    n = 32 * K
    NEG = -(10**7)
    RING = 8
    total = ctas * W
    chain = min(total, -(-Ls // n))  # the warps that own a column
    assert 32 * K * W * (ctas - 1) < Ls <= total * n  # no block without a column
    sl = sl.to(i32)
    s_all = torch.zeros((B, chain * n), dtype=i32)
    s_all[:, :Ls] = s.to(i32)
    plane = torch.empty((Lq, B, chain * n), dtype=i32)
    warps = []
    for w in range(chain):
        c = torch.arange(w * n + 1, (w + 1) * n + 1, dtype=i32).reshape(1, 32, K)
        st = dict(c=c, s_ch=s_all[:, w * n:(w + 1) * n].reshape(B, 32, K),
                  m=torch.full((B, 32, K), NEG, dtype=i32),
                  i=torch.full((B, 32, K), NEG, dtype=i32),
                  d=(torch.zeros((B, 32, K), dtype=i32) if free_start2 else
                     (-open_gap - ext_gap * (c - 1)).expand(B, 32, K).to(i32)),
                  cwm=torch.zeros((B, 32, K), dtype=i32),
                  cwi=torch.zeros((B, 32, K), dtype=i32))
        if w == 0:
            st["m0"] = st["i0"] = st["d0"] = torch.zeros(B, dtype=i32)
        warps.append(st)
    prefixes, hand = {}, {}  # (receiving warp, row): the two halves of a message
    for w in range(1, chain):  # row 1's hand-off: column w*32K's initial state
        d_cb = 0 if free_start2 else -open_gap - ext_gap * (w * n - 1)
        full = lambda v: torch.full((B,), v, dtype=i32)
        hand[w, 1] = _diag_out(full(NEG), full(NEG), full(d_cb), full(0))
    best = torch.where(sl == 0, 0, NEG).to(i32)
    brow = torch.where(sl == 0, 0, Lq).to(i32)

    def row(w, r):
        st = warps[w]
        c, m, i, d, cwm, cwi = (st[k] for k in ("c", "m", "i", "d", "cwm", "cwi"))
        qc = q[:, r - 1].to(i32)[:, None, None]
        active = (r <= ql)[:, None, None]
        i0n = 0 if free_start1 else -open_gap - ext_gap * (r - 1)
        am0 = NEG - open_gap
        ai0 = i0n - open_gap
        a0 = max(am0, ai0)
        if w > 0:
            yseed, zseed = prefixes.pop((w, r))
            hd0, mw0 = hand.pop((w, r))
        else:
            hd0, mw0 = _diag_out(st["m0"], st["i0"], st["d0"], torch.zeros(B, dtype=i32))
        hd, mw = _diag_out(m, i, d, cwm)
        shift = lambda x, x0: torch.cat([x0[:, None], x.reshape(B, n)[:, :-1]],
                                        dim=1).reshape(B, 32, K)
        hd_in, mw_in = shift(hd, hd0), shift(mw, mw0)
        m_row = hd_in + torch.where(st["s_ch"] == qc, match, -mismatch).to(i32)
        cm, ci, cd = m - open_gap, i - ext_gap, d - open_gap
        ci_ge_cd = ci >= cd
        mx = torch.maximum(ci, cd)
        cm_ge = cm >= mx
        i_row = torch.maximum(cm, mx)
        grown = torch.minimum(cwi + 0x10000, cwi | 0xFF0000)
        cwi_row = torch.where(cm_ge, 0x10000, torch.where(ci_ge_cd, grown, 0x10008)).to(i32)
        m_ge_i = m_row >= i_row
        y = torch.maximum(m_row, i_row) - open_gap + ext_gap * c
        run = torch.cummax(y, dim=2).values
        yincl = _warp_scan_max(run[:, :, K - 1])
        z0 = (4 + (0 if am0 >= ai0 else 1)) if a0 >= NEG - ext_gap else -1
        if w == 0:
            yseed = torch.full((B,), a0, dtype=i32)
            zseed = torch.full((B,), max(z0, 0), dtype=i32)
        pre = _excl_from_incl(yincl, yseed)[:, :, None]
        left = torch.cat([pre, torch.maximum(pre, run[:, :, :-1])], dim=2)
        d_row = left - ext_gap * (c - 1)
        z = torch.where(y >= left, (c + 1) * 4 + torch.where(m_ge_i, 0, 1), -1).to(i32)
        zrun = torch.cummax(z, dim=2).values
        zincl = _warp_scan_max(zrun[:, :, K - 1])
        zpre = _excl_from_incl(zincl, zseed)[:, :, None]
        st["m"] = m = torch.where(active, m_row, m)
        st["i"] = i = torch.where(active, i_row, i)
        st["d"] = d = torch.where(active, d_row, d)
        st["cwm"] = cwm = torch.where(active, mw_in, cwm)
        st["cwi"] = cwi = torch.where(active, cwi_row, cwi)
        if w == 0:
            act = active[:, 0, 0]
            st["m0"] = torch.where(act, NEG, st["m0"]).to(i32)
            st["i0"] = torch.where(act, i0n, st["i0"]).to(i32)
            st["d0"] = torch.where(act, NEG, st["d0"]).to(i32)
        if w + 1 < chain:  # lane 31: row r's prefixes, row r+1's hand-off
            prefixes[w + 1, r] = (torch.maximum(yseed, yincl[:, 31]),
                                  torch.maximum(zseed, zincl[:, 31]))
            hand[w + 1, r + 1] = _diag_out(m[:, 31, K - 1], i[:, 31, K - 1],
                                           d[:, 31, K - 1], cwm[:, 31, K - 1])
            assert sum(key[0] == w + 1 for key in hand) <= RING
        orun = torch.cat([zpre, torch.maximum(zpre, zrun[:, :, :-1])], dim=2)
        sd = orun & 3
        ed = torch.clamp(c - (orun >> 2) + 1, max=255)
        plane[r - 1, :, w * n:(w + 1) * n] = (cwm | cwi | (sd << 4) | (ed << 24)).reshape(B, n)
        return m.reshape(B, n), active[:, 0, 0]

    for t in range(1, Lq + chain):
        for w in reversed(range(chain)):
            r = t - w
            if not 1 <= r <= Lq:
                continue
            m_seg, act = row(w, r)
            if free_end1:  # the lane that owns column slen
                own = sl - w * n - 1
                mine = (own >= 0) & (own < n)
                at = m_seg.gather(1, own.clamp(0, n - 1).long()[:, None])[:, 0]
                upd = mine & act & (at >= best)
                best = torch.where(upd, at, best)
                brow = torch.where(upd, r, brow).to(i32)
    assert not prefixes and all(r == Lq + 1 for _, r in hand)

    plane = plane[:, :, :Ls]
    m, i, d = (torch.cat([st[k].reshape(B, n) for st in warps], dim=1) for k in "mid")
    m0, i0, d0 = warps[0]["m0"], warps[0]["i0"], warps[0]["d0"]
    zeros = torch.zeros(B, dtype=i32)
    if free_end1:
        return plane, best, sl, zeros, brow
    c = torch.arange(1, chain * n + 1)[None, :]
    if free_end2:
        low = torch.iinfo(torch.int64).min
        key = torch.where(c <= sl[:, None], m, NEG).long() * (1 << 32) + c
        key = torch.where(c <= Ls, key, low)  # columns past Ls do not count
        # each block's best over its warps (block 0's with column 0), then
        # block 0's reduction of the blocks'
        blocks = torch.full((B, total * n), low, dtype=torch.int64)
        blocks[:, : chain * n] = key
        blocks = blocks.reshape(B, ctas, W * n).amax(dim=2)
        blocks[:, 0] = torch.maximum(blocks[:, 0], m0.long() * (1 << 32))
        key = blocks.amax(dim=1)
        end_j = key & 0xFFFFFFFF
        return plane, ((key - end_j) // (1 << 32)).to(i32), end_j.to(i32), zeros, ql.to(i32)
    sc = sl.clamp(0, Ls).long()[:, None]
    pick = lambda x, x0: torch.cat([x0[:, None], x], dim=1).gather(1, sc)[:, 0]
    mc, ic, dc = pick(m, m0), pick(i, i0), pick(d, d0)
    score = torch.where(ic > mc, ic, mc)
    sk = torch.where(ic > mc, 1, 0)
    score = torch.where(dc > score, dc, score)
    sk = torch.where(dc > torch.maximum(mc, ic), 2, sk)
    return plane, score, sl, sk.to(i32), ql.to(i32)


@pytest.mark.parametrize("cfg", _WIDE_CFGS, ids=_WIDE_CFG_IDS)
@pytest.mark.parametrize(
    "B,Lq,Ls,layout",
    [(4, 24, 257, (8, 2)), (4, 20, 288, None), (4, 20, 384, None), (4, 16, 512, None),
     (4, 12, 1024, (4, 8)), (4, 12, 1664, None), (4, 300, 300, None)],
    ids=["Ls257-last-warp-one-column", "Ls288", "Ls384-K6", "Ls512", "Ls1024-K4-W8",
         "Ls1664", "saturating-runs"],
)
def test_seg_kernel_decomposition_reproduces_plain_plane(B, Lq, Ls, layout, cfg):
    """Full plane and final vectors of the seg kernel's model against the
    plain version, in skewed order: ragged qlen with qlen 0, N runs, slen
    0, runs past 255."""
    rng = np.random.default_rng(B * 11 + Lq + Ls)
    q, ql, s, sl = _noisy(rng, B, Lq, Ls)
    if Lq >= 300:  # M and I runs longer than the 8-bit saturation
        q[0] = 1
        s[0] = 1
        ql[0], sl[0] = Lq, Ls
        q[1] = 4
        ql[1] = Lq
    ql[-1] = 0
    sl[-2] = 0
    q[2, Lq // 2 :] = 4
    s[2, Ls // 2 :] = 4
    K, W = layout or seg_layout(Ls, cfg.get("free_end1", False))
    want = gotoh_forward_plane_ref(T(q), T(ql), T(s), T(sl), **cfg)
    got = _seg_kernel_model(T(q), T(ql), T(s), T(sl), K=K, W=W, **cfg)
    if Lq >= 300:
        assert int(((want[0] >> 8) & 255).max()) == 255
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[3])
    assert torch.equal(got[3], want[4])
    assert torch.equal(got[4], want[2])


@pytest.mark.parametrize("cfg", _WIDE_CFGS, ids=_WIDE_CFG_IDS)
@pytest.mark.parametrize(
    "B,Lq,Ls,layout_B,layout",
    [(4, 12, 3585, 4, None), (4, 12, 4096, 4, None), (4, 10, 5000, 4, None),
     (3, 12, 3936, 69, None), (3, 300, 380, None, (2, 1, 6))],
    ids=["Ls3585", "Ls4096", "Ls5000", "Ls3936-MSA-layout", "saturating-runs-N2-W1"],
)
def test_cluster_kernel_decomposition_reproduces_plain_plane(B, Lq, Ls, layout_B, layout,
                                                             cfg):
    """Full plane and final vectors of the cluster kernel's model (the seg
    chain over the blocks of a cluster) against the plain version at
    cluster_layout's (N, W, K) on 132 SMs for a batch of layout_B (or the
    layout given): ragged qlen with qlen 0, N runs, slen 0; runs past 255
    across a block boundary.  At Ls 3,585 the last block holds a warp past
    the row's end."""
    rng = np.random.default_rng(B * 13 + Lq + Ls)
    q, ql, s, sl = _noisy(rng, B, Lq, Ls)
    if Lq >= 300:  # M and I runs longer than the 8-bit saturation
        q[0] = 1
        s[0] = 1
        ql[0], sl[0] = Lq, Ls
        q[1] = 4
        ql[1] = Lq
    ql[-1] = 0
    sl[-2] = 0
    q[2, Lq // 2 :] = 4
    s[2, Ls // 2 :] = 4
    N, W, K = layout or cluster_layout(layout_B, Ls, cfg.get("free_end1", False), 132)
    assert N >= 2
    want = gotoh_forward_plane_ref(T(q), T(ql), T(s), T(sl), **cfg)
    got = _seg_kernel_model(T(q), T(ql), T(s), T(sl), K=K, W=W, ctas=N, **cfg)
    if Lq >= 300:
        assert int(((want[0] >> 8) & 255).max()) == 255
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[3])
    assert torch.equal(got[3], want[4])
    assert torch.equal(got[4], want[2])


def test_cluster_layout_invariants():
    """cluster_layout over a grid of (B, Ls, free_end1) at 132 SMs: every
    column owned, every block with a column (so only the last block can
    hold warps past the row's end, fewer than a block's), N <= 8, W <= 16,
    4 <= K <= 8 (6 with a free query end), the least cost of the busiest
    SM (ceil(B / h) waves of ceil(min(B, h) N / 132) blocks of K (3W + 4),
    h the clusters held at once) and the fewest N at a tie; the MSA's
    69x3936 pinned, with the SM arithmetic and with an H100's clusters."""
    # 207 blocks of 6 warps: two on 75 SMs.  N 2 (W 8, K 8) puts 138
    # blocks of 8 warps on the 132 SMs, so 6 SMs hold two halves of an
    # alignment and set every cluster's pace: 10.70 ms against 7.61.
    assert cluster_layout(69, 3936, False, 132) == (3, 6, 7)
    h100 = {1: 132, 2: 132, 3: 79, 4: 124, 5: 94, 6: 101, 7: 84, 8: 124}  # at 3936
    assert cluster_layout(69, 3936, False, 132, held=lambda n, W, K: h100[n]) == (3, 6, 7)
    # at 16,384 columns the SM arithmetic takes N 6 (W 11: 22 clusters at
    # once, two waves of 37); an H100 holds 17 of them, three waves
    # (1.159 ms), and the rule takes N 5 (W 13, 22 held: 0.944 ms)
    assert cluster_layout(37, 16384, False, 132) == (6, 11, 8)
    h100 = {4: 30, 5: 22, 6: 17, 7: 15, 8: 30}  # at 16384
    assert cluster_layout(37, 16384, False, 132, held=lambda n, W, K: h100[n]) == (5, 13, 8)
    assert cluster_layout(69, 3936, True, 132) == (5, 5, 5)
    assert cluster_shape(3936, False, 2) == (8, 8)
    assert cluster_shape(3936, False, 4) == (4, 8)
    assert cluster_layout(69, 3936, False, 132, ctas=2) == (2, 8, 8)
    assert cluster_layout(5, 3585, True, 132) == (8, 3, 5)  # 23 of 24 warps in the chain
    with pytest.raises(ValueError):  # 8 x 16 x 32 x 6 columns at the most
        cluster_layout(4, CLUSTER_MAX_LS + 1, True, 132)
    for free_end1, most in ((False, 8), (True, 6)):
        for B in (1, 5, 37, 69, 93, 132, 256, 300, 2048):
            for Ls in list(range(SEG_MAX_LS + 1, CLUSTER_MAX_LS + 1, 397)) + [
                    SEG_MAX_LS + 1, 4096, 3936, 5000, 8192, 16384, CLUSTER_MAX_LS]:
                N, W, K = cluster_layout(B, Ls, free_end1, 132)
                assert 1 <= N <= 8 and 1 <= W <= 16 and 4 <= K <= most
                assert N * W * 32 * K >= Ls  # every column owned
                assert (N - 1) * W * 32 * K < Ls  # every block owns one
                def cost(n, W, K):
                    h = 132 * (16 // W) // n
                    return -(-B // h) * -(-min(B, h) * n // 132) * K * (3 * W + 4)

                costs = [(cost(n, *cluster_shape(Ls, free_end1, n)), n)
                         for n in range(1, 9) if cluster_shape(Ls, free_end1, n)]
                assert (cost(N, W, K), N) == min(costs)


def test_kernel_choice_at_the_width_boundaries():
    """kernel_for and seg_layout where the kernels meet: the warp kernel up
    to 256 columns, the seg kernel (the fewest warps of at most 8 columns a
    lane, 7 with a free query end, then the fewest columns a lane) up to
    SEG_MAX_LS, the cluster kernel up to CLUSTER_MAX_LS, the wide kernel
    above; every width of the cluster kernel's range has a layout in every
    configuration."""
    assert SEG_MAX_LS >= 2048
    assert CLUSTER_MAX_LS == 8 * 16 * 32 * 6
    assert [kernel_for(Ls) for Ls in (1, 256, 257, SEG_MAX_LS, SEG_MAX_LS + 1,
                                      CLUSTER_MAX_LS, CLUSTER_MAX_LS + 1)] == [
        "warp", "warp", "seg", "seg", "cluster", "cluster", "wide"]
    for free_end1 in (False, True):
        for Ls in range(SEG_MAX_LS + 1, CLUSTER_MAX_LS + 1):
            assert any(cluster_shape(Ls, free_end1, n) for n in range(1, 9))
    assert seg_layout(257) == (5, 2)
    assert seg_layout(384) == (6, 2)
    assert seg_layout(512) == (8, 2)
    assert seg_layout(1664) == (8, 7)
    assert seg_layout(512, free_end1=True) == (6, 3)
    assert seg_layout(1664, free_end1=True) == (7, 8)
    assert seg_layout(SEG_MAX_LS, free_end1=True) == (7, 16)  # 16 warps a block
    for free_end1, most in ((False, 8), (True, 7)):
        for Ls in range(1, SEG_MAX_LS + 1):
            K, W = seg_layout(Ls, free_end1)
            assert 4 <= K <= most and W <= 16
            assert 32 * K * W >= Ls  # every column owned
            assert 32 * K * (W - 1) < Ls  # no warp without a column
            assert W == -(-Ls // (32 * most))


@pytest.mark.parametrize("cfg", _CFGS, ids=_CFG_IDS)
def test_gotoh_plane_ref_wide_matches_pallas(cfg):
    """Ls 1,536 (a multiple of the Pallas kernel's 128 lanes, B its one
    tile of 256): the plane on the cells the Pallas kernel defines and the
    final vectors, tolerance 0."""
    rng = np.random.default_rng(1536)
    q, ql, s, sl = _noisy(rng, 256, 16, 1536)
    jplane, jscore, jend_j, jstart_k = gotoh_forward_plane_pallas(
        q, ql, s, sl, interpret=True, **cfg
    )
    plane, score, end_i, end_j, start_k = gotoh_forward_plane_ref(
        T(q), T(ql), T(s), T(sl), **cfg
    )
    mask = _plane_mask(q.shape[1], s.shape[1], ql, sl)
    assert np.array_equal(plane.numpy()[mask], np.asarray(jplane).view(np.int32)[mask])
    assert np.array_equal(score.numpy(), np.asarray(jscore))
    assert np.array_equal(end_j.numpy(), np.asarray(jend_j))
    assert np.array_equal(start_k.numpy(), np.asarray(jstart_k))


@pytest.mark.parametrize("cfg", _WIDE_CFGS, ids=_WIDE_CFG_IDS)
def test_runs_wide_match_jax_scan(cfg):
    """Ls 1,536 at a small B through the JAX package's XLA scan and the
    run-jump walk with the tier-2 budget R = Lq + Ls: every output equal."""
    rng = np.random.default_rng(7)
    q, ql, s, sl = _noisy(rng, 5, 40, 1536)
    ql[-1] = 0
    R = q.shape[1] + s.shape[1]
    j = _to_np(jpw.affine_gap_align_runs(q, ql, s, sl, walk_runs=R, **cfg))
    t = tpw.affine_gap_align_runs(T(q), T(ql), T(s), T(sl), walk_runs=R, **cfg)
    _assert_runs_equal(t, j)


# ---------------------------------------------------------------------------
# argument checks of the wrapper, made before the device branch

def _valid_args(B=4, Lq=8, Ls=16):
    return [
        torch.zeros((B, Lq), dtype=torch.int8), torch.full((B,), Lq, dtype=torch.int32),
        torch.zeros((B, Ls), dtype=torch.int8), torch.full((B,), Ls, dtype=torch.int32),
    ]


@pytest.mark.parametrize(
    "case,exc",
    [("wide", None), ("empty", ValueError), ("dtype", TypeError),
     ("subject_dtype", TypeError), ("batch", ValueError), ("qlen_shape", ValueError)],
)
def test_gotoh_wrapper_rejects_bad_arguments(case, exc):
    q, ql, s, sl = _valid_args()
    if case == "wide":  # no width limit: 1,025 columns run as any other
        s = torch.zeros((4, 1025), dtype=torch.int8)
        sl = torch.full((4,), 1025, dtype=torch.int32)
    elif case == "empty":
        s = torch.zeros((4, 0), dtype=torch.int8)
    elif case == "dtype":
        q = q.to(torch.int32)
    elif case == "subject_dtype":
        s = s.to(torch.uint8)
    elif case == "batch":
        s = torch.zeros((5, 16), dtype=torch.int8)
    elif case == "qlen_shape":
        ql = ql[:3]
    if exc is None:
        assert gotoh_forward_plane(q, ql, s, sl)[0].shape == (8, 4, 1025)
        with pytest.raises(ValueError):  # the forced kernels take CUDA tensors only
            gotoh_forward_plane_cluster(q, ql, s, sl)
        return
    with pytest.raises(exc):
        gotoh_forward_plane(q, ql, s, sl)
    # what the checks let through still runs
    assert gotoh_forward_plane(*_valid_args())[0].shape == (8, 4, 16)
