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
    gotoh_forward_plane,
    gotoh_forward_plane_ref,
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
