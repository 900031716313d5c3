"""The run-jump walk kernel (csrc/run_walk.cu) as a torch model on the CPU.

`_walk_kernel_model` is a per-row scalar loop written statement for
statement as run_walk.cu's thread does it: walk until done or R steps,
reverse the first n_raw entries in place, merge in place, zero the rest.
It must equal the plain version `_runs_from_plane_ref` (what the kernel is
held to on the card) on planes from the plain Gotoh forward pass: the
tier-3 budget, the tier-2 budget (R = Lq + Ls), runs past 255, rows whose
budget runs out, and the empty query with a free query end, whose walk
reads frozen rows of run length 0.
"""
import numpy as np
import pytest
import torch

from ngsepcore_tpu_torch.kernels import pairwise as tpw
from ngsepcore_tpu_torch.kernels.pairwise_cuda import gotoh_forward_plane_ref

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

TIER2_LEFT = dict(free_end1=True, free_start2=True, free_end2=False)
TIER2_RIGHT = dict(free_start1=True, free_start2=False, free_end2=True)


def _walk_kernel_model(plane, end_i, end_j, start_k, R, free_start2):
    """run_walk.cu's arithmetic, one row at a time, in Python integers."""
    Lq, B, Ls = plane.shape
    words = plane.numpy().astype(np.int64) & 0xFFFFFFFF
    emit_lead_del = not free_start2
    rop = np.full((B, R), -7, np.int64)  # torch.empty: garbage until written
    rlen = np.full((B, R), -7, np.int64)
    n_runs = np.zeros(B, np.int64)
    n_ops = np.zeros(B, np.int64)
    start_j = np.zeros(B, np.int64)
    walk_ok = np.zeros(B, bool)
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
        len_row[rank + 1 :] = 0
        op_row[rank + 1 :] = 0
        n_runs[b], n_ops[b] = rank + 1, total
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
