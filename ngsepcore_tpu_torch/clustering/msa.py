"""Best-star multiple sequence alignment.

Ref: src/ngsep/clustering/msa/BestStarMultipleSequenceAlignmentAlgorithm
.java — pick the star center minimizing the total pairwise edit distance,
align every other sequence to it pairwise, then merge the pairwise
alignments by forcing each new center gap into all previously merged rows.

Counterpart of ngsepcore_tpu/clustering/msa.py: the all-pairs distances and
the center-vs-all alignments run as one batched affine-gap DP each
(kernels/pairwise.affine_gap_align_batch: on a CUDA device the Gotoh kernel
and the run-jump walk), only the final gap-merging is host string work.
The rows of a batch are independent, so a batch whose (Lq, B, Ls) int32
plane would pass PLANE_BUDGET_BYTES runs in row chunks under it; the
outputs are those of one batch.  The JAX package pads a batch's rows to a
power of two (shared compiled programs); the port does not.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.sequences import decode_dna, encode_dna, pack_reads
from ..kernels.pairwise import affine_gap_align_batch

GAP = "-"
# the most bytes of Gotoh plane one batch chunk may take on the device
PLANE_BUDGET_BYTES = 4 << 30


def _align_pairs(pairs: list[tuple[np.ndarray, np.ndarray]], device, keys):
    """One unit-cost affine-gap DP over sequence pairs (both packed to the
    widest sequence, multiples of 32), in row chunks whose plane stays under
    PLANE_BUDGET_BYTES; returns {key: (B,) array} of the outputs `keys`,
    on the host."""
    L = max(max(len(a), len(b)) for a, b in pairs)
    q, ql, _ = pack_reads([a for a, _ in pairs], pad_to=L, pad_multiple=32)
    s, sl, _ = pack_reads([b for _, b in pairs], pad_to=L, pad_multiple=32)
    rows = max(1, PLANE_BUDGET_BYTES // (4 * q.shape[1] * s.shape[1]))
    parts = {k: [] for k in keys}
    for lo in range(0, len(pairs), rows):
        hi = min(lo + rows, len(pairs))
        out = affine_gap_align_batch(
            *(torch.from_numpy(x[lo:hi]).to(device) for x in (q, ql, s, sl)),
            match=1, mismatch=1, open_gap=1, ext_gap=1,
        )
        for k in keys:
            parts[k].append(out[k].cpu().numpy())
    return {k: np.concatenate(v) for k, v in parts.items()}


def _batched_align(pairs: list[tuple[np.ndarray, np.ndarray]], device):
    """Run one batched unit-cost DP over sequence pairs; returns list of
    (aligned1, aligned2) strings."""
    if not pairs:
        return []
    out = _align_pairs(pairs, device, ("ops", "n_ops", "start_j"))
    return [
        _ops_to_strings(out["ops"][i], int(out["n_ops"][i]), a, b, int(out["start_j"][i]))
        for i, (a, b) in enumerate(pairs)
    ]


def _ops_to_strings(ops, n, qcodes, scodes, start_j):
    """Expand traceback ops to two gapped strings."""
    q = decode_dna(qcodes)
    s = decode_dna(scodes)
    out_q, out_s = [], []
    qi, sj = 0, start_j
    out_s.append(s[:start_j])
    out_q.append(GAP * start_j)
    for k in range(n):
        op = int(ops[k])
        if op == 1:  # match/mismatch
            out_q.append(q[qi])
            out_s.append(s[sj])
            qi += 1
            sj += 1
        elif op == 2:  # insertion (gap in subject)
            out_q.append(q[qi])
            out_s.append(GAP)
            qi += 1
        elif op == 3:  # deletion (gap in query)
            out_q.append(GAP)
            out_s.append(s[sj])
            sj += 1
    out_q.append(q[qi:])
    out_s.append(s[sj:] + GAP * max(0, (len(q) - qi) - (len(s) - sj)))
    a1 = "".join(out_q)
    a2 = "".join(out_s)
    m = max(len(a1), len(a2))
    return a1.ljust(m, GAP), a2.ljust(m, GAP)


class BestStarMultipleSequenceAlignmentAlgorithm:
    def __init__(self, *, device):
        self.device = torch.device(device)

    def calculate_multiple_sequence_alignment(self, sequences: list[str]) -> list[str]:
        """Returns gapped sequences (center first) of equal length."""
        n = len(sequences)
        if n == 0:
            return []
        if n == 1:
            return list(sequences)
        codes = [encode_dna(s) for s in sequences]
        # all-pairs distances in one batch (score ~ -editDistance under
        # unit costs; higher score = closer)
        pairs = [(codes[i], codes[j]) for i in range(n) for j in range(i + 1, n)]
        scores = _align_pairs(pairs, self.device, ("score",))["score"]
        D = np.zeros((n, n))
        k = 0
        for i in range(n):
            for j in range(i + 1, n):
                d = max(len(codes[i]), len(codes[j])) - scores[k]
                D[i, j] = D[j, i] = d
                k += 1
        center = int(np.argmin(D.sum(axis=1)))
        others = [i for i in range(n) if i != center]
        aligned_pairs = _batched_align([(codes[center], codes[o]) for o in others],
                                       self.device)

        # merge pairwise alignments into one MSA (gap forcing, ref :60-120)
        msa_center = aligned_pairs[0][0]
        rows = [aligned_pairs[0][1]]
        for (c_aln, o_aln) in aligned_pairs[1:]:
            merged_center, g1, g2 = _merge_centers(msa_center, c_aln)
            rows = [_apply_gaps(r, g1) for r in rows]
            rows.append(_apply_gaps(o_aln, g2))
            msa_center = merged_center
            width = len(msa_center)
            rows = [r.ljust(width, GAP) for r in rows]
        result = [msa_center] + rows
        order = [center] + others
        final = [""] * n
        for pos, idx in enumerate(order):
            final[idx] = result[pos]
        return final


def _merge_centers(c1: str, c2: str) -> tuple[str, list[int], list[int]]:
    """Merge two gapped versions of the same center; returns the union
    center plus the gap positions to force into rows aligned to c1 / c2."""
    i = j = 0
    out = []
    g1: list[int] = []  # gap columns to insert into c1-aligned rows
    g2: list[int] = []
    while i < len(c1) or j < len(c2):
        a = c1[i] if i < len(c1) else None
        b = c2[j] if j < len(c2) else None
        if a == b or (a is not None and b is not None and a != GAP and b != GAP):
            out.append(a if a is not None else b)
            i += 1
            j += 1
        elif a == GAP:
            out.append(GAP)
            g2.append(len(out) - 1)
            i += 1
        elif b == GAP or a is None:
            out.append(GAP if b == GAP else b)
            g1.append(len(out) - 1)
            j += 1
        else:
            out.append(a)
            i += 1
            j += 1
    return "".join(out), g1, g2


def _apply_gaps(row: str, gap_cols: list[int]) -> str:
    out = list(row)
    for col in gap_cols:
        out.insert(min(col, len(out)), GAP)
    return "".join(out)
