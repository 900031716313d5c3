"""Batched simple-gap (linear) and static-banded pairwise alignment.

Ref: src/ngsep/alignments/PairwiseAlignerSimpleGap.java:29-273 — single-matrix
NW with linear gap cost `openGap`, forceStart/forceEnd flags (free ends score
0 at the boundary and search the last column/row), `local` mode (clamp at 0,
traceback from the global max until a 0 cell), and traceback preference
diagonal > up (seq1 consumed) > left.
Ref: src/ngsep/alignments/PairwiseAlignerStaticBanded.java:8-160 — global NW
restricted to a diagonal band of half-width k (requires |L1-L2| <= k), linear
gap `indel`, same traceback preference.

Counterpart of ngsepcore_tpu/kernels/pairwise_simple.py, as plain PyTorch on
the tensors' device: one loop iteration a query row, each row vectorized over
subject positions and the batch.  The in-row left-move chain has linear cost,
so it collapses to a closed-form cumulative max:
S[i][j] = max_{e<=j}(cand[e] - gap*(j-e)) = cummax(cand + gap*e) - gap*j.
The banded DP keeps rows in band coordinates d = j - i + k (O(2k+1) work a
row).  The tracebacks are one loop iteration a step over the whole batch;
they stop once every row has emitted its last op, which changes no output
(a row that emits no op at a step emits none later).  Nothing in the port
but its tests calls these yet, so they have no hand-written kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from .pairwise import OP_DEL, OP_INS, OP_MATCH, OP_NONE
from .pairwise_cuda import NEG

# traceback pointer codes
PTR_DIAG = 0
PTR_UP = 1  # seq1 (query) consumed: OP_INS
PTR_LEFT = 2  # seq2 (subject) consumed: OP_DEL
PTR_START = 3  # local-mode zero cell: alignment starts here

_I32 = torch.int32
_DONE_CHECK_EVERY = 16  # traceback steps between asks whether every row is done


def _last_max(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(max along dim, index of its LAST occurrence)."""
    best = x.max(dim=dim).values
    hit = (x == best.unsqueeze(dim)).flip(dim).to(torch.int8)
    last = x.shape[dim] - 1 - hit.argmax(dim=dim)
    return best, last.to(_I32)


def _forward_order(ops_rev, n_ops):
    """Reverse the first n_ops entries of each row; OP_NONE after them."""
    idx = torch.arange(ops_rev.shape[1], dtype=torch.int64, device=ops_rev.device)[None, :]
    src = n_ops.long()[:, None] - 1 - idx
    return torch.where(src >= 0, ops_rev.gather(1, src.clamp(min=0)),
                       torch.zeros_like(ops_rev)).to(torch.uint8)


def simple_gap_align_batch(
    query: torch.Tensor,  # (B, Lq) int8 codes, padded
    qlen: torch.Tensor,  # (B,) int32
    subject: torch.Tensor,  # (B, Ls) int8 codes, padded
    slen: torch.Tensor,  # (B,) int32
    match: int = 1,
    mismatch: int = 1,
    gap: int = 2,
    force_start1: bool = True,
    force_start2: bool = True,
    force_end1: bool = True,
    force_end2: bool = True,
    local: bool = False,
):
    """Batch linear-gap alignment of query[i] vs subject[i] on the tensors'
    device.

    Mirrors PairwiseAlignerSimpleGap semantics exactly (boundary rows
    :137-151, free-end search :196-221, tail emission :223-232, traceback
    order :236-255, local max = last (i,j) in row-major order :188-201).

    Returns dict: score (B,), ops (B, Lq+Ls) uint8 forward order, n_ops (B,),
    start_i/start_j (B,) 0-based alignment starts (local mode), end_i/end_j.
    """
    dev = query.device
    B, Lq = query.shape
    Ls = subject.shape[1]
    qlen = qlen.to(_I32)
    slen = slen.to(_I32)
    jj = torch.arange(Ls + 1, dtype=_I32, device=dev)
    in_row = jj[None, :] <= slen[:, None]
    s_row = torch.where(in_row, -gap * jj if force_start2 else torch.zeros_like(jj),
                        NEG).to(_I32)
    gap_j = (gap * jj)[None, :]
    neg_col = torch.full((B, 1), NEG, dtype=_I32, device=dev)
    valid = (jj[None, :] >= 1) & in_row
    best = torch.zeros(B, dtype=_I32, device=dev)
    bi = torch.zeros(B, dtype=_I32, device=dev)
    bj = torch.zeros(B, dtype=_I32, device=dev)
    ptr_rows, s_cols = [], []
    for i in range(1, Lq + 1):
        s_prev = s_row
        sub = torch.where(subject == query[:, i - 1 : i], match, -mismatch).to(_I32)
        diag_inner = s_prev[:, :-1] + sub
        up_inner = s_prev[:, 1:] - gap
        c0 = torch.full((B, 1), -gap * i if force_start1 else 0, dtype=_I32, device=dev)
        cand = torch.maximum(diag_inner, up_inner)
        if local:
            cand = cand.clamp(min=0)
        a = torch.cat([c0, cand], dim=1)
        s_row = torch.cummax(a + gap_j, dim=1).values - gap_j
        if local:
            s_row = s_row.clamp(min=0)
        s_row[:, 0:1] = c0
        s_row = torch.where(in_row, s_row, NEG).to(_I32)
        diag_cand = torch.cat([neg_col, diag_inner], dim=1)
        up_cand = torch.cat([neg_col, up_inner], dim=1)
        left_cand = torch.cat([neg_col, s_row[:, :-1] - gap], dim=1)
        ptr = torch.where(
            s_row == diag_cand, PTR_DIAG,
            torch.where(s_row == up_cand, PTR_UP,
                        torch.where(s_row == left_cand, PTR_LEFT, PTR_START)))
        if local:
            ptr = torch.where(s_row == 0, PTR_START, ptr)
        ptr_rows.append(ptr[:, 1:].to(torch.uint8))
        # running interior max: the LAST (largest i, then largest j) tie wins
        masked = torch.where(valid, s_row, NEG)
        row_best, row_bj = _last_max(masked, 1)
        active = i <= qlen
        take = active & (row_best >= best)
        best = torch.where(take, row_best, best)
        bi = torch.where(take, i, bi)
        bj = torch.where(take, row_bj, bj)
        s_row = torch.where(active[:, None], s_row, s_prev)
        s_cols.append(torch.where(active, s_row.gather(1, slen.long()[:, None])[:, 0], NEG))
    ptrs = (torch.stack(ptr_rows) if ptr_rows
            else torch.zeros((0, B, Ls), dtype=torch.uint8, device=dev))  # (Lq, B, Ls)

    if local:
        score, end_i, end_j = best, bi, bj
    elif not force_end1:
        # best over the last column, ties at the largest row (ref :196-204)
        h0 = torch.where(slen == 0, 0, -gap * slen if force_start2 else torch.zeros_like(slen))
        stack = torch.stack([h0.to(_I32)] + s_cols)  # (Lq+1, B)
        rows = torch.arange(Lq + 1, device=dev)[:, None]
        stack = torch.where(rows <= qlen[None, :], stack, NEG)
        score, end_i = _last_max(stack, 0)
        end_j = slen
    elif not force_end2:
        masked = torch.where(in_row, s_row, NEG)
        score, end_j = _last_max(masked, 1)
        end_i = qlen
    else:
        score = s_row.gather(1, slen.long()[:, None])[:, 0]
        end_i, end_j = qlen, slen

    # --- traceback: tails first (ref :223-232), then pointer walk ---------
    max_steps = Lq + Ls
    bb = torch.arange(B, device=dev)
    i, j = (qlen.clone(), slen.clone()) if not local else (end_i.clone(), end_j.clone())
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    ops = torch.zeros((B, max_steps), dtype=torch.int64, device=dev)
    si, sj = end_i.clone(), end_j.clone()
    for step in range(max_steps):
        if local:
            tail1 = tail2 = torch.zeros_like(done)
        else:
            # unaligned tails: query tail as INS then subject tail as DEL,
            # emitted back-to-front so they land AFTER the core alignment
            tail1 = i > end_i
            tail2 = (i == end_i) & (j > end_j)
        in_core = ~tail1 & ~tail2 & ~done
        if Lq and Ls:
            p = ptrs[(i - 1).clamp(min=0).long(), bb, (j - 1).clamp(min=0).long()].to(_I32)
        else:
            p = torch.zeros_like(i)
        both = (i > 0) & (j > 0)
        from_ptr = torch.where(p == PTR_DIAG, OP_MATCH, torch.where(p == PTR_UP, OP_INS, OP_DEL))
        if local:
            core_op = torch.where(both & (p != PTR_START), from_ptr, OP_NONE)
        else:
            core_op = torch.where(
                both, from_ptr,
                torch.where(i > 0, OP_INS, torch.where(j > 0, OP_DEL, OP_NONE)))
        op = torch.where(tail1, OP_INS,
                         torch.where(tail2, OP_DEL, torch.where(in_core, core_op, OP_NONE)))
        done = done | (in_core & (core_op == OP_NONE))
        di = ((op == OP_MATCH) | (op == OP_INS)).to(_I32)
        dj = ((op == OP_MATCH) | (op == OP_DEL)).to(_I32)
        emits = op != OP_NONE
        at = n.clamp(max=max_steps - 1)
        ops[bb, at] = torch.where(emits, op, ops[bb, at])
        n = n + emits.long()
        emitted = emits & in_core
        si = torch.where(emitted, i - di, si)
        sj = torch.where(emitted, j - dj, sj)
        i, j = i - di, j - dj
        if step % _DONE_CHECK_EVERY == _DONE_CHECK_EVERY - 1 and not bool(emits.any()):
            break
    n_ops = n.to(_I32)
    return {
        "score": score.to(_I32),
        "ops": _forward_order(ops, n_ops),
        "n_ops": n_ops,
        "start_i": si.to(_I32),
        "start_j": sj.to(_I32),
        "end_i": end_i.to(_I32),
        "end_j": end_j.to(_I32),
    }


def banded_align_batch(
    query: torch.Tensor,  # (B, Lq) int8, padded
    qlen: torch.Tensor,  # (B,) int32
    subject: torch.Tensor,  # (B, Ls) int8, padded
    slen: torch.Tensor,  # (B,) int32
    k: int = 3,
    match: int = 1,
    mismatch: int = 1,
    indel: int = 2,
):
    """Batch static-banded global alignment (band half-width k) on the
    tensors' device.

    Rows live in band coordinates d = j - i + k in [0, 2k].  Requires
    |slen - qlen| <= k per pair (caller-checked, ref checkminK).  Returns
    dict: score (B,), ops (B, Lq+Ls) uint8 forward, n_ops (B,).
    """
    dev = query.device
    B, Lq = query.shape
    Ls = subject.shape[1]
    qlen = qlen.to(_I32)
    slen = slen.to(_I32)
    W = 2 * k + 1
    dd = torch.arange(W, dtype=_I32, device=dev)
    j0 = dd[None, :] - k
    b_row = torch.where((j0 >= 0) & (j0 <= slen[:, None]), -indel * j0, NEG).to(_I32)
    gap_d = (indel * dd)[None, :]
    neg_col = torch.full((B, 1), NEG, dtype=_I32, device=dev)
    ptr_rows = []
    for i in range(1, Lq + 1):
        b_prev = b_row
        j_row = dd[None, :] + (i - k)
        valid = (j_row >= 0) & (j_row <= slen[:, None])
        s_char = subject.gather(1, (j_row - 1).clamp(0, Ls - 1).long().expand(B, W))
        sub = torch.where(s_char == query[:, i - 1 : i], match, -mismatch).to(_I32)
        diag = b_prev + sub
        up = torch.cat([b_prev[:, 1:], neg_col], dim=1) - indel
        cand = torch.maximum(diag, up)
        is_j0 = (j_row == 0).expand(B, W)
        cand = torch.where(is_j0, -indel * i, cand)
        b_row = torch.cummax(cand + gap_d, dim=1).values - gap_d
        b_row = torch.where(valid, b_row, NEG).to(_I32)
        ptr = torch.where(
            is_j0, PTR_UP,
            torch.where(b_row == diag, PTR_DIAG, torch.where(b_row == up, PTR_UP, PTR_LEFT)))
        ptr_rows.append(ptr.to(torch.uint8))
        b_row = torch.where((i <= qlen)[:, None], b_row, b_prev)
    ptrs = (torch.stack(ptr_rows) if ptr_rows
            else torch.zeros((0, B, W), dtype=torch.uint8, device=dev))  # (Lq, B, W)
    d_fin = (slen - qlen + k).clamp(0, W - 1)
    score = b_row.gather(1, d_fin.long()[:, None])[:, 0]

    max_steps = Lq + Ls
    bb = torch.arange(B, device=dev)
    i, d = qlen.clone(), d_fin.clone()
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    ops = torch.zeros((B, max_steps), dtype=torch.int64, device=dev)
    for step in range(max_steps):
        j = d + i - k
        at_origin = (i <= 0) & (j <= 0)
        if Lq:
            p = ptrs[(i - 1).clamp(min=0).long(), bb, d.clamp(0, W - 1).long()].to(_I32)
        else:
            p = torch.zeros_like(i)
        op = torch.where(
            at_origin, OP_NONE,
            torch.where(i == 0, OP_DEL,
                        torch.where(p == PTR_DIAG, OP_MATCH,
                                    torch.where(p == PTR_UP, OP_INS, OP_DEL))))
        di = ((op == OP_MATCH) | (op == OP_INS)).to(_I32)
        nd = torch.where(op == OP_MATCH, d, torch.where(op == OP_INS, d + 1, d - 1))
        nd = torch.where(op == OP_NONE, d, nd)
        emits = op != OP_NONE
        at = n.clamp(max=max_steps - 1)
        ops[bb, at] = torch.where(emits, op, ops[bb, at])
        n = n + emits.long()
        i, d = i - di, nd
        if step % _DONE_CHECK_EVERY == _DONE_CHECK_EVERY - 1 and not bool(emits.any()):
            break
    n_ops = n.to(_I32)
    return {"score": score.to(_I32), "ops": _forward_order(ops, n_ops), "n_ops": n_ops}


def ops_to_strings(
    ops: np.ndarray,
    n_ops: int,
    q: str,
    s: str,
    start_i: int = 0,
    start_j: int = 0,
) -> tuple[str, str]:
    """Host: ops -> gapped aligned strings (reference calculateAlignment)."""
    a1, a2 = [], []
    i, j = start_i, start_j
    for op in ops[:n_ops]:
        if op == OP_MATCH:
            a1.append(q[i]); a2.append(s[j]); i += 1; j += 1
        elif op == OP_INS:
            a1.append(q[i]); a2.append("-"); i += 1
        elif op == OP_DEL:
            a1.append("-"); a2.append(s[j]); j += 1
    return "".join(a1), "".join(a2)
