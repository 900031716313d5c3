"""The run-jump walk kernel (csrc/run_walk.cu) as a torch model on the CPU.

`_walk_kernel_model` is a per-row scalar loop written statement for
statement as run_walk.cu's thread does it: walk until done or R steps,
reverse the first n_raw entries in place, merge in place, zero the rest.
It must equal the plain version `_runs_from_plane_ref` (what the kernel is
held to on the card) on planes from the plain Gotoh forward pass: the
tier-3 budget, the tier-2 budget (R = Lq + Ls), runs past 255, rows whose
budget runs out, and the empty query with a free query end, whose walk
reads frozen rows of run length 0.

The kernel's tier-3 and hamming epilogues are modelled the same way, with
the left-alignment's backward compare in place of the plain version's
tables.  They must equal the plain composites (the plain walk, then
dp_stats_runs or dp_stats_runs_hamming) and the JAX package's walk and
statistics, on planes from the Gotoh forward pass and on synthetic planes
that put chosen runs in front of the walk: each case asserts that it
reaches what it is named for.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngsepcore_tpu.kernels import pairwise as jpw
from ngsepcore_tpu_torch.kernels import pairwise as tpw
from ngsepcore_tpu_torch.kernels.pairwise_cuda import gotoh_forward_plane_ref

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

TIER2_LEFT = dict(free_end1=True, free_start2=True, free_end2=False)
TIER2_RIGHT = dict(free_start1=True, free_start2=False, free_end2=True)


def _shift_room(x, L, l, pos, cap):
    """run_walk.cu's shift_room: the backward compare that stands for the
    brl table of _left_align_rle at (l, pos), stopped after cap equal
    pairs."""
    n = 0
    u = pos
    while n < cap and u >= 0 and u + l < L and x[u] == x[u + l]:
        n += 1
        u -= 1
    return n


def _int16(v):
    """A C cast of an int to int16_t (and torch's .to(torch.int16))."""
    return (v + (1 << 15)) % (1 << 16) - (1 << 15)


def _walk_kernel_model(plane, end_i, end_j, start_k, R, free_start2, mode="runs",
                       score=None, query=None, subject=None, trace=None):
    """run_walk.cu's arithmetic, one row at a time, in Python integers.
    mode "runs" returns the walk's outputs; "tier3" and "hamming" run the
    kernel's epilogues on the merged runs and return their outputs.  With
    `trace` a list, tier 3 appends (b, t, op, l, p, lens[t-1], k before the
    next-slot test, next_m) for every gap run after an M run."""
    Lq, B, Ls = plane.shape
    words = plane.numpy().astype(np.int64) & 0xFFFFFFFF
    emit_lead_del = not free_start2
    rop = np.full((B, R), -7, np.int64)  # torch.empty: garbage until written
    rlen = np.full((B, R), -7, np.int64)
    n_runs = np.zeros(B, np.int64)
    n_ops = np.zeros(B, np.int64)
    start_j = np.zeros(B, np.int64)
    walk_ok = np.zeros(B, bool)
    mism = np.zeros(B, np.int64)
    rle = np.full((B, R), -7, np.int64)
    has_gap = np.zeros(B, np.int64)
    la_fallback = np.zeros(B, np.int64)
    if mode != "runs":
        score = np.asarray(score).astype(np.int64)
    if mode == "tier3":
        query, subject = np.asarray(query), np.asarray(subject)
    for b in range(B):
        i, j, k = int(end_i[b]), int(end_j[b]), int(start_k[b])
        op_row, len_row = rop[b], rlen[b]
        steps = n_raw = 0
        while steps < R:
            if i > 0 and j > 0:
                w = int(words[i - 1, b, j - 1])
                src = (w >> (2 * k)) & 3
                run = (w >> (8 * k + 8)) & 255
                sat = run == 255
                r = 254 if sat else run
                op, ln = k + 1, r
                if k in (0, 1):
                    i -= r
                if k in (0, 2):
                    j -= r
                if not sat:
                    k = src
            elif i > 0 and j == 0:
                op, ln, i = tpw.OP_INS, i, 0
            elif i == 0 and j > 0 and emit_lead_del:
                op, ln, j = tpw.OP_DEL, j, 0
            else:
                break
            op_row[steps], len_row[steps] = op, ln
            n_raw += ln > 0
            steps += 1
        start_j[b] = j
        walk_ok[b] = i == 0 and (j == 0 or not emit_lead_del)
        a, z = 0, n_raw - 1
        while a < z:
            len_row[a], len_row[z] = len_row[z], len_row[a]
            op_row[a], op_row[z] = op_row[z], op_row[a]
            a += 1
            z -= 1
        prev, rank, cur_len, cur_op, total = -1, -1, 0, 0, 0
        for t in range(n_raw):
            ln, op = int(len_row[t]), int(op_row[t])
            total += ln
            if ln > 0 and op != prev:
                if rank >= 0:
                    len_row[rank], op_row[rank] = cur_len, cur_op
                rank += 1
                cur_len, cur_op = 0, op
            if rank >= 0:
                cur_len += ln
            prev = op
        if rank >= 0:
            len_row[rank], op_row[rank] = cur_len, cur_op
        n = rank + 1
        n_runs[b], n_ops[b] = n, total
        if mode == "runs":
            len_row[n:] = 0
            op_row[n:] = 0
            continue
        rle_row = rle[b]
        m_cnt = gap_len = k_all = k_runs = 0
        if mode == "hamming":
            for t in range(n):
                op, ln = int(op_row[t]), int(len_row[t])
                gap = op in (tpw.OP_INS, tpw.OP_DEL)
                if op == tpw.OP_MATCH:
                    m_cnt += ln
                if gap:
                    gap_len += ln
                    k_all += 1
                rle_row[t] = _int16(op | (ln << 2))
            rle_row[n:] = 0
            sub_mm = (m_cnt - int(score[b]) - 2 * k_all - gap_len) >> 1
            mism[b] = sub_mm + gap_len if walk_ok[b] else 30000
            continue
        q_row, s_row = query[b], subject[b]
        fallback = False
        pq, ps = 0, int(start_j[b])
        prev_op = prev_len = carry = 0
        for t in range(n):
            op, ln = int(op_row[t]), int(len_row[t])
            is_ins = op == tpw.OP_INS
            gap = is_ins or op == tpw.OP_DEL
            if op == tpw.OP_MATCH:
                m_cnt += ln
            if gap:
                gap_len += ln
                k_all += 1
                k_runs += prev_op == tpw.OP_MATCH
                fallback |= ln > tpw.LA_LMAX
            k = 0
            if t >= 1:
                next_m = t + 1 < n and int(op_row[t + 1]) == tpw.OP_MATCH
                if gap and prev_op == tpw.OP_MATCH and 1 <= ln <= tpw.LA_LMAX:
                    p = pq if is_ins else ps
                    L = Lq if is_ins else Ls
                    pos = min(max(p - 1, 0), L - 1)
                    k = _shift_room(q_row if is_ins else s_row, L, ln, pos,
                                    min(prev_len, p))
                    if trace is not None:
                        trace.append((b, t, op, ln, p, prev_len, k, next_m))
                fallback |= k > 0 and not next_m
                if not next_m:
                    k = 0
                prev_len -= k
                rle_row[t - 1] = _int16(prev_op | (prev_len << 2))
            if is_ins or op == tpw.OP_MATCH:
                pq += ln
            if op == tpw.OP_DEL or op == tpw.OP_MATCH:
                ps += ln
            prev_op, prev_len, carry = op, ln + carry, k
        if n > 0:
            rle_row[n - 1] = _int16(prev_op | (prev_len << 2))
        rle_row[n:] = 0
        ends_gap = n > 0 and prev_op in (tpw.OP_INS, tpw.OP_DEL)
        sub_mm = (m_cnt - int(score[b]) - 2 * k_all - gap_len) >> 1
        mism[b] = sub_mm + 2 * k_runs - 2 * int(ends_gap) if walk_ok[b] else 32000
        has_gap[b] = k_all > 0
        la_fallback[b] = fallback
    if mode == "tier3":
        return dict(mism=mism, has_gap=has_gap, rle=rle, n_runs=n_runs, n_ops=n_ops,
                    start_j=start_j, la_fallback=la_fallback)
    if mode == "hamming":
        return dict(rle=rle, n_runs=n_runs, mism=mism, start_j=start_j,
                    end_j=np.asarray(end_j).astype(np.int64), walk_ok=walk_ok)
    return dict(rop=rop, rlen=rlen, n_runs=n_runs, n_ops=n_ops,
                start_j=start_j, walk_ok=walk_ok)


def _noisy(rng, B, Lq, Ls):
    """Queries embedded in subjects with a few indels, ragged lengths."""
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


def _cases():
    """(name, inputs, Gotoh flags, budget) — budget None is tier 3's."""
    rng = np.random.default_rng(12)
    # queries that skip one subject base in every seven: a deletion run
    # every six matches, far more runs than the tier-3 budget of 16
    subj = rng.integers(0, 4, (24, 96)).astype(np.int8)
    keep = (np.arange(96) % 7 != 6)
    rnd = [subj[:, keep][:, :64].copy(), np.full(24, 64, np.int32),
           subj, np.full(24, 96, np.int32)]
    # identical and all-N rows: M and I runs past the 8-bit run lengths
    sat = list(_noisy(rng, 6, 300, 320))
    sat[0][0], sat[2][0] = 1, 1
    sat[0][1] = 4
    sat[1][:2], sat[3][:2] = 300, 320
    # the empty query with a free query end, beside ordinary flank rows
    empty = list(_noisy(rng, 8, 48, 96))
    empty[1][[0, 3]] = 0
    return [
        ("tier 3, free subject ends", _noisy(rng, 40, 96, 128), {}, None),
        ("global", _noisy(rng, 16, 64, 80), dict(free_start2=False, free_end2=False), None),
        ("budget runs out", rnd, {}, None),
        ("tier-2 left flank, R = Lq + Ls", _noisy(rng, 16, 64, 160), TIER2_LEFT, "Lq+Ls"),
        ("tier-2 right flank, R = Lq + Ls", _noisy(rng, 16, 64, 160), TIER2_RIGHT, "Lq+Ls"),
        ("runs past 255", sat, {}, "Lq+Ls"),
        ("empty query, free query end", empty, TIER2_LEFT, "Lq+Ls"),
    ]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_walk_kernel_model_equals_plain_walk(case):
    name, (q, ql, s, sl), cfg, budget = case
    args = [torch.from_numpy(a) for a in (q, ql, s, sl)]
    plane, score, end_i, end_j, start_k = gotoh_forward_plane_ref(*args, **cfg)
    B, Lq = q.shape
    R = Lq + s.shape[1] if budget else tpw._walk_runs_for(Lq)
    free_start2 = cfg.get("free_start2", True)
    ref = tpw._runs_from_plane_ref(plane, score, end_i, end_j, start_k, B, R, free_start2)
    got = _walk_kernel_model(plane, end_i, end_j, start_k, R, free_start2)
    for key, want in got.items():
        np.testing.assert_array_equal(ref[key].numpy(), want, err_msg=f"{name}: {key}")
    # the CPU dispatch is the plain version
    cpu = tpw._runs_from_plane(plane, score, end_i, end_j, start_k, B, R, free_start2)
    for key in ref:
        assert torch.equal(cpu[key], ref[key]), key
    # each case reaches what it is named for
    if name == "budget runs out":
        assert not ref["walk_ok"].all()
    if name == "runs past 255":
        assert (ref["rlen"] > 255).any()
    if name.startswith("empty query"):
        rows = torch.from_numpy(ql == 0)
        assert (end_i[rows] == Lq).all() and (ref["n_ops"][rows] == 0).all()


def test_walk_on_another_device_raises():
    """Only CPU tensors take the plain walk; no device falls back to it."""
    plane = torch.zeros((4, 2, 4), dtype=torch.int32, device="meta")
    vec = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpw._runs_from_plane(plane, vec, vec, vec, vec, 2, 8, True)


# --- the tier-3 and hamming epilogues ---------------------------------------

M, I, D = tpw.OP_MATCH, tpw.OP_INS, tpw.OP_DEL


def _codes(rng, B, L, homopolymer=()):
    """Random codes 0..3 with N (4) padding from a random length on; rows
    in `homopolymer` are all A."""
    x = rng.integers(0, 4, (B, L)).astype(np.int8)
    x[list(homopolymer)] = 0
    return x


def _synthetic(rng, rows, Lq, Ls, R, fs2=True, q=None, s=None):
    """(plane, score, end_i, end_j, start_k, R, free_start2, query, subject)
    for synthetic rows, random scores of both signs and parities."""
    B = len(rows)
    plane, end_i, end_j, start_k = tpw.plane_from_runs(rows, Lq, Ls)
    q = _codes(rng, B, Lq) if q is None else q
    s = _codes(rng, B, Ls) if s is None else s
    score = torch.from_numpy(rng.integers(-60, 60, B).astype(np.int32))
    return (plane, score, end_i, end_j, start_k, R, fs2, torch.from_numpy(q),
            torch.from_numpy(s))


def _from_gotoh(q, ql, s, sl, R=None, **cfg):
    args = [torch.from_numpy(a) for a in (q, ql, s, sl)]
    plane, score, end_i, end_j, start_k = gotoh_forward_plane_ref(*args, **cfg)
    R = tpw._walk_runs_for(q.shape[1]) if R is None else R
    return (plane, score, end_i, end_j, start_k, R, cfg.get("free_start2", True),
            args[0], args[2])


def _homopolymer_jobs(rng, B, Lq, Ls):
    """Reads from subjects made of short homopolymer runs, with indels of
    1-4 bases and a few substitutions (tests/test_torch_pairwise.py's
    _gapped_jobs): gap runs that the left-alignment shifts."""
    q = np.full((B, Lq), 4, np.int8)
    s = np.full((B, Ls), 4, np.int8)
    ql = np.zeros(B, np.int32)
    sl = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(Ls - 20, Ls + 1))
        sub = []
        while len(sub) < n:
            sub.extend([int(rng.integers(0, 4))] * int(rng.integers(1, 6)))
        sub = np.array(sub[:n], np.int8)
        off = int(rng.integers(0, 8))
        read = list(sub[off : off + Lq - 8])
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(1, max(2, len(read) - 2)))
            ln = int(rng.integers(1, 5))
            if rng.random() < 0.5:
                read[p:p] = [int(rng.integers(0, 4))] * ln
            else:
                del read[p : p + ln]
        read = read[:Lq]
        q[b, : len(read)] = read
        ql[b] = len(read)
        s[b, :n] = sub
        sl[b] = n
    return q, ql, s, sl


def _stats_cases():
    """(name, walk inputs) for the epilogues: planes from the plain Gotoh
    forward pass (tier 3's free subject ends) and synthetic planes that
    put given runs in front of the walk."""
    rng = np.random.default_rng(21)
    cases = [
        ("random tier-3 chunks", _from_gotoh(*_homopolymer_jobs(rng, 96, 64, 80))),
        ("random tier-3 chunks, noisy", _from_gotoh(*_noisy(rng, 40, 96, 128))),
    ]
    sat = list(_noisy(rng, 6, 300, 320))
    sat[0][0], sat[2][0] = 1, 1
    sat[0][1] = 4
    sat[1][:2], sat[3][:2] = 300, 320
    cases.append(("saturated runs (> 255)", _from_gotoh(*sat)))
    subj = rng.integers(0, 4, (24, 96)).astype(np.int8)
    keep = np.arange(96) % 7 != 6
    cases.append(("an exhausted budget", _from_gotoh(
        subj[:, keep][:, :64].copy(), np.full(24, 64, np.int32), subj,
        np.full(24, 96, np.int32))))
    cases.append(("a gap longer than LA_LMAX", _synthetic(rng, [
        ([(M, 10), (I, 20), (M, 10)], 3),
        ([(M, 12), (D, 17), (M, 9)], 0),
        ([(M, 8), (I, 16), (M, 8), (D, 30), (M, 5)], 2),
    ], 48, 80, 12)))
    # homopolymer rows: every gap after an M shifts as far as it may
    cases.append(("a shift whose next run is not M", _synthetic(rng, [
        ([(M, 10), (I, 2), (D, 2), (M, 10)], 4),
        ([(M, 6), (D, 3), (I, 1), (M, 12)], 1),
        ([(M, 9), (I, 3)], 0),
    ], 40, 48, 10, q=_codes(rng, 3, 40, (0, 1, 2)), s=_codes(rng, 3, 48, (0, 1, 2)))))
    cases.append(("gaps at either end", _synthetic(rng, [
        ([(I, 3), (M, 20), (I, 2)], 5),
        ([(I, 4), (M, 12), (D, 2), (M, 6)], 0),
        ([(M, 15), (I, 6)], 2),
        ([(D, 3), (M, 20), (D, 2)], 0),
    ], 32, 40, 8, fs2=False)))
    cases.append(("a shift bounded by the preceding M and by p", _synthetic(rng, [
        ([(M, 3), (I, 2), (M, 10)], 0),       # k = 3 = lens[t-1] = p
        ([(M, 3), (D, 2), (M, 10)], 0),
        ([(I, 4), (M, 3), (I, 2), (M, 10)], 0),  # k = lens[t-1] = 3 < p = 7
        ([(M, 5), (D, 1), (M, 2), (D, 2), (M, 9)], 6),  # shifts grow the M between
    ], 32, 40, 10, q=_codes(rng, 4, 32, range(4)), s=_codes(rng, 4, 40, range(4)))))
    # the walk keeps every run inside [0, L): a gap ending in the row's last
    # column is as far as a compare reaches (test_shift_room_equals_brl_tables
    # takes the lags past L)
    q_end = _codes(rng, 3, 24, (0,))
    q_end[1, 16:] = q_end[1, 12:20]
    cases.append(("a lag that reaches the row's end", _synthetic(rng, [
        ([(M, 20), (I, 4)], 0),
        ([(M, 16), (I, 4), (M, 4)], 0),
        ([(M, 22), (I, 2)], 1),
    ], 24, 32, 8, q=q_end)))
    q_n = _codes(rng, 3, 32, ())
    q_n[:, 6:] = 4  # reads ending in Ns, then the padding
    cases.append(("padding code 4 at row ends", _synthetic(rng, [
        ([(M, 10), (I, 2), (M, 3)], 0),
        ([(M, 12), (I, 3), (M, 8)], 2),
        ([(M, 7), (I, 1), (M, 20)], 1),
    ], 32, 40, 8, q=q_n)))
    empty = list(_noisy(rng, 16, 48, 96))
    empty[1][[0, 3, 7]] = 0
    cases.append(("an empty query", _from_gotoh(*empty)))
    return cases


def _brl_full(x, L, l, pos):
    return _shift_room(x, L, l, pos, 1 << 30)


def _assert_reaches(name, t3, hm, trace, inputs):
    """Each case reaches what it is named for."""
    plane, score, end_i, end_j, start_k, R, fs2, q, s = inputs
    lens = t3["rle"].astype(np.int64) >> 2
    ops = t3["rle"].astype(np.int64) & 3
    shifted = [e for e in trace if e[6] > 0]
    if name.startswith("random"):
        # the walk already prefers leftmost gaps: rows with gaps after an M,
        # whose backward compare ran
        assert t3["has_gap"].sum() > 10 and len(trace) > 10
    elif name.startswith("saturated"):
        assert (lens > 255).any()
    elif name.startswith("an exhausted"):
        assert (t3["mism"] == 32000).any() and (hm["mism"] == 30000).any()
    elif name.startswith("a gap longer"):
        long_gap = ((ops >= I) & (lens > tpw.LA_LMAX)).any(axis=1)
        assert long_gap.all() and (t3["la_fallback"][long_gap] == 1).all()
    elif name.startswith("a shift whose"):
        fb = [e for e in shifted if not e[7]]
        assert len({e[0] for e in fb}) == 3
        assert all(t3["la_fallback"][e[0]] == 1 for e in fb)
    elif name.startswith("gaps at either"):
        n = t3["n_runs"]
        first, last = ops[:, 0], ops[np.arange(len(n)), n - 1]
        assert ((first == I) | (first == D)).sum() >= 2 and ((last == I) | (last == D)).sum() >= 2
        assert (first == D).any() and (last == D).any()
    elif name.startswith("a shift bounded"):
        x = lambda e: (q if e[2] == I else s)[e[0]].numpy()
        Lx = lambda e: q.shape[1] if e[2] == I else s.shape[1]
        by_m = [e for e in shifted if e[6] == e[5]
                and _brl_full(x(e), Lx(e), e[3], e[4] - 1) > e[5]]
        by_p = [e for e in shifted if e[6] == e[4]]
        assert by_m and by_p
        assert any(e[5] > 3 for e in shifted)  # an M that an earlier shift grew
    elif name.startswith("a lag"):
        at_end = [e for e in shifted if e[4] + e[3] == q.shape[1]]
        assert at_end
    elif name.startswith("padding"):
        on_n = [e for e in shifted if (q[e[0], e[4] - 1 : e[4] + e[3]] == 4).all()]
        assert len(on_n) == 3
    elif name.startswith("an empty"):
        rows = torch.tensor([0, 3, 7])
        assert (t3["n_runs"][rows] == 0).all() and (hm["n_runs"][rows] == 0).all()


@pytest.mark.parametrize("case", _stats_cases(), ids=lambda c: c[0])
def test_walk_epilogues_equal_plain_and_jax(case):
    """The tier-3 and hamming epilogues of the kernel model equal the plain
    composites (the plain walk, then dp_stats_runs / dp_stats_runs_hamming),
    the CPU dispatch of tier3_walk_stats / segment_walk_stats, and the JAX
    package's walk and dp_stats_runs / dp_stats_runs_hamming."""
    name, inputs = case
    plane, score, end_i, end_j, start_k, R, fs2, q, s = inputs
    B = plane.shape[1]
    wargs = (plane, score, end_i, end_j, start_k, B, R, fs2)
    ref_out = tpw._runs_from_plane_ref(*wargs)
    plain = {"tier3": tpw.dp_stats_runs(ref_out, q, s),
             "hamming": tpw.dp_stats_runs_hamming(ref_out)}
    cpu = {"tier3": tpw.tier3_walk_stats(*wargs[:7], q, s, free_start2=fs2),
           "hamming": tpw.segment_walk_stats(*wargs)}
    jout = jpw._runs_from_plane(
        *(jnp.asarray(t.numpy()) for t in (plane, score, end_i, end_j, start_k)),
        B, R, fs2, None)
    jst = {"tier3": jpw.dp_stats_runs(jout, q.numpy(), s.numpy()),
           "hamming": jpw.dp_stats_runs_hamming(jout)}
    trace = []
    model = {mode: _walk_kernel_model(plane, end_i, end_j, start_k, R, fs2, mode, score,
                                      q, s, trace if mode == "tier3" else None)
             for mode in ("tier3", "hamming")}
    for mode in ("tier3", "hamming"):
        assert set(model[mode]) == set(plain[mode]) == set(jst[mode])
        for key, want in plain[mode].items():
            msg = f"{name}, {mode}: {key}"
            np.testing.assert_array_equal(model[mode][key], want.numpy(), err_msg=msg)
            np.testing.assert_array_equal(np.asarray(jst[mode][key]), want.numpy(), err_msg=msg)
            assert cpu[mode][key].dtype == want.dtype and torch.equal(cpu[mode][key], want), msg
    _assert_reaches(name, {k: v.numpy() for k, v in plain["tier3"].items()},
                    {k: v.numpy() for k, v in plain["hamming"].items()}, trace, inputs)


def test_shift_room_equals_brl_tables():
    """The backward compare equals the plain version's tables at every lag
    1..LA_LMAX and position, lags past L and rows narrower than a lag
    included, with N (4) codes and N padding, for caps below and above the
    tables' values."""
    rng = np.random.default_rng(5)
    for L in (1, 5, 12, 16, 17, 40):
        x = rng.integers(0, 3, (6, L)).astype(np.int8)
        x[1] = 0
        x[2, L // 2 :] = 4  # N tail
        x[3] = 4
        tab = tpw._brl_tables(torch.from_numpy(x)).numpy()
        for b in range(x.shape[0]):
            for l in range(1, tpw.LA_LMAX + 1):
                for pos in range(L):
                    want = int(tab[b, (l - 1) * L + pos])
                    for cap in (0, 1, 3, L + 1):
                        assert _shift_room(x[b], L, l, pos, cap) == min(want, cap), (
                            L, b, l, pos, cap)


def test_walk_stats_wrappers_raise_on_another_device():
    """Only CPU tensors take the plain composites; no device falls back."""
    plane = torch.zeros((4, 2, 4), dtype=torch.int32, device="meta")
    vec = torch.zeros(2, dtype=torch.int32, device="meta")
    codes = torch.zeros((2, 4), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpw.tier3_walk_stats(plane, vec, vec, vec, vec, 2, 8, codes, codes)
    with pytest.raises(ValueError, match="unsupported device"):
        tpw.segment_walk_stats(plane, vec, vec, vec, vec, 2, 8, True)
