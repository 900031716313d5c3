"""Pairwise aligner family with the reference's dispatch surface.

Ref: src/ngsep/alignments/PairwiseAligner.java (interface),
PairwiseAlignerSimpleGap.java (linear gap + force flags + local),
PairwiseAlignerStaticBanded.java (k-banded global, checkminK),
PairwiseAlignerNaive.java (gap-pad the shorter sequence),
PairwiseAlignerAffineGap.java (Gotoh — kernels/pairwise.py).

Counterpart of ngsepcore_tpu/align/pairwise_aligners.py.  Each aligner
exposes `calculate_alignment(s1, s2) -> (a1, a2)` gapped strings plus
`get_max_score`, and runs on the device it was given: a single pair is a
batch of one at its own widths (the JAX package pads it to a power of two
so that calls share compiled programs).  The affine-gap aligner's forward
pass on a CUDA device is the Gotoh kernel (csrc/gotoh_forward.cu) with
its run-jump walk (csrc/run_walk.cu); the simple-gap and banded ones are
plain PyTorch (kernels/pairwise_simple.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.sequences import encode_dna
from ..kernels.pairwise import affine_gap_align_batch
from ..kernels.pairwise_simple import (
    banded_align_batch,
    ops_to_strings,
    simple_gap_align_batch,
)


def _pack_pair(s1: str, s2: str, device):
    """(query, qlen, subject, slen) of one pair on `device`, each code row
    at least one column wide."""
    q = encode_dna(s1)
    s = encode_dna(s2)
    qa = np.zeros((1, max(1, len(q))), np.int8)
    sa = np.zeros((1, max(1, len(s))), np.int8)
    qa[0, : len(q)] = q
    sa[0, : len(s)] = s
    return (
        torch.from_numpy(qa).to(device),
        torch.tensor([len(q)], dtype=torch.int32, device=device),
        torch.from_numpy(sa).to(device),
        torch.tensor([len(s)], dtype=torch.int32, device=device),
    )


def _host(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


class PairwiseAlignerSimpleGap:
    """Linear-gap NW/local aligner (ref PairwiseAlignerSimpleGap.java:29)."""

    def __init__(self, match: int = 1, mismatch: int = 1, open_gap: int = 2, *, device):
        self.match = match
        self.mismatch = mismatch
        self.open_gap = open_gap
        self.device = torch.device(device)
        self.force_start1 = True
        self.force_start2 = True
        self.force_end1 = True
        self.force_end2 = True
        self.local = False
        self.max_score = 0

    def set_local(self, local: bool) -> None:
        """Ref setLocal:112-115 — local clears all force flags."""
        self.local = local
        if local:
            self.force_start1 = self.force_start2 = False
            self.force_end1 = self.force_end2 = False

    def _run(self, s1: str, s2: str):
        qa, ql, sa, sl = _pack_pair(s1, s2, self.device)
        return _host(simple_gap_align_batch(
            qa, ql, sa, sl,
            match=self.match, mismatch=self.mismatch, gap=self.open_gap,
            force_start1=self.force_start1, force_start2=self.force_start2,
            force_end1=self.force_end1, force_end2=self.force_end2,
            local=self.local,
        ))

    def calculate_alignment(self, s1: str, s2: str) -> tuple[str, str]:
        out = self._run(s1, s2)
        self.max_score = int(out["score"][0])
        start_i = int(out["start_i"][0]) if self.local else 0
        start_j = int(out["start_j"][0]) if self.local else 0
        return ops_to_strings(
            out["ops"][0], int(out["n_ops"][0]), s1, s2, start_i, start_j
        )

    def get_max_score(self, s1: str | None = None, s2: str | None = None) -> int:
        if s1 is not None:
            self.max_score = int(self._run(s1, s2)["score"][0])
        return self.max_score

    @staticmethod
    def align_batch(query, qlen, subject, slen, **kw):
        """Batched entry point over padded int8 code tensors (their device)."""
        return simple_gap_align_batch(query, qlen, subject, slen, **kw)


class PairwiseAlignerStaticBanded:
    """k-banded global aligner (ref PairwiseAlignerStaticBanded.java:8)."""

    def __init__(self, k: int = 3, match: int = 1, mismatch: int = 1,
                 indel: int = 2, *, device):
        self.k = k
        self.match = match
        self.mismatch = mismatch
        self.indel = indel
        self.device = torch.device(device)
        self.max_score = 0

    def _check_k(self, s1: str, s2: str) -> None:
        # ref checkminK: the band must contain the (L1, L2) corner
        if abs(len(s1) - len(s2)) > self.k:
            raise ValueError("K value is not possible")

    def _run(self, s1: str, s2: str):
        self._check_k(s1, s2)
        qa, ql, sa, sl = _pack_pair(s1, s2, self.device)
        out = _host(banded_align_batch(
            qa, ql, sa, sl, k=self.k,
            match=self.match, mismatch=self.mismatch, indel=self.indel,
        ))
        self.max_score = int(out["score"][0])
        return out

    def calculate_alignment(self, s1: str, s2: str) -> tuple[str, str]:
        out = self._run(s1, s2)
        return ops_to_strings(out["ops"][0], int(out["n_ops"][0]), s1, s2)

    def get_max_score(self, s1: str, s2: str) -> int:
        self._run(s1, s2)
        return self.max_score

    @staticmethod
    def align_batch(query, qlen, subject, slen, k, **kw):
        return banded_align_batch(query, qlen, subject, slen, k=k, **kw)


class PairwiseAlignerNaive:
    """Gap-pads the shorter sequence (ref PairwiseAlignerNaive.java:20-40)."""

    def __init__(self, gaps_left: bool = True):
        self.gaps_left = gaps_left

    def calculate_alignment(self, s1: str, s2: str) -> tuple[str, str]:
        diff = len(s1) - len(s2)
        g = "-" * abs(diff)
        a1, a2 = s1, s2
        if self.gaps_left:
            if diff > 0:
                a2 = g + a2
            elif diff < 0:
                a1 = g + a1
        else:
            if diff > 0:
                a2 = a2 + g
            elif diff < 0:
                a1 = a1 + g
        return a1, a2


class PairwiseAlignerAffineGap:
    """String facade over the batched Gotoh alignment (kernels/pairwise.py).

    Ref: PairwiseAlignerAffineGap.java:29-292 (match=1 mismatch=1 openGap=3
    extGap=1, forceStart/forceEnd flags).  With every force flag set (the
    default) no end is free."""

    def __init__(self, match: int = 1, mismatch: int = 1, open_gap: int = 3,
                 ext_gap: int = 1, *, device):
        self.match = match
        self.mismatch = mismatch
        self.open_gap = open_gap
        self.ext_gap = ext_gap
        self.device = torch.device(device)
        self.force_start1 = True
        self.force_start2 = True
        self.force_end1 = True
        self.force_end2 = True
        self.max_score = 0

    def calculate_alignment(self, s1: str, s2: str) -> tuple[str, str]:
        qa, ql, sa, sl = _pack_pair(s1, s2, self.device)
        out = _host(affine_gap_align_batch(
            qa, ql, sa, sl,
            match=self.match, mismatch=self.mismatch,
            open_gap=self.open_gap, ext_gap=self.ext_gap,
            free_start1=not self.force_start1, free_end1=not self.force_end1,
            free_start2=not self.force_start2, free_end2=not self.force_end2,
        ))
        self.max_score = int(out["score"][0])
        a1, a2 = ops_to_strings(out["ops"][0], int(out["n_ops"][0]), s1, s2, 0,
                                int(out["start_j"][0]))
        # unaligned query tail under free_end1 (the alignment stops at end_i)
        end_i = int(out["end_i"][0])
        if end_i < len(s1):
            a1 += s1[end_i:]
            a2 += "-" * (len(s1) - end_i)
        return a1, a2
