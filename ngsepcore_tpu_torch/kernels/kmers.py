"""Canonical k-mer codes on device.

Ref: DNASequence.java:132-178 — `getDNAHash`/`getNextDNAHash` scalar rolling
2-bit hash per position.  Here: one vectorized shift-accumulate over a
(reads, positions) code tensor, all positions at once.  Codes use the
reference's alphabet order A=0,C=1,G=2,T=3 (DNASequence.java:33-34).
"""
from __future__ import annotations

import numpy as np
import torch

N_CODE = 4


def kmer_codes_canonical_2x32(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Canonical (strand-symmetric) k-mer codes as two int32 halves.

    codes (n, L) int8, lengths (n,) int32.  For each window the forward and
    reverse-complement codes are computed in one unrolled pass and the
    lexicographically smaller one is kept, with flag=1 when the
    reverse-complement won.  lo holds the last min(k, 15) bases, hi the
    first k-15.  Palindromic windows (fwd == rc, only possible for even k)
    are dropped.  Non-ACGT bases break the window.

    Returns (hi, lo, flag, valid): (n, L-k+1) int32, int32, int32, bool.
    """
    assert k <= 30
    n, L = codes.shape
    nk = L - k + 1
    dev = codes.device
    c = codes.to(torch.int32)
    split = max(0, k - 15)
    fhi = torch.zeros((n, nk), dtype=torch.int32, device=dev)
    flo = torch.zeros_like(fhi)
    rhi = torch.zeros_like(fhi)
    rlo = torch.zeros_like(fhi)
    ok = torch.ones((n, nk), dtype=torch.bool, device=dev)
    for j in range(k):
        cj = c[:, j : j + nk]
        acgt = cj < 4
        v = torch.where(acgt, cj, 0)
        w = 3 - v
        if j < split:
            fhi = fhi * 4 + v
        else:
            flo = flo * 4 + v
        # reverse-complement base index m = k-1-j: j>=15 lands in rc_hi with
        # weight 4^(j-15), j<15 in rc_lo with weight 4^j
        if j >= 15:
            rhi = rhi + (w << (2 * (j - 15)))
        else:
            rlo = rlo + (w << (2 * j))
        ok &= acgt
    pos = torch.arange(nk, dtype=torch.int32, device=dev)[None, :]
    ok &= pos + k <= lengths.to(torch.int32)[:, None]
    fwd_le = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    flag = torch.where(fwd_le, 0, 1).to(torch.int32)
    hi = torch.where(fwd_le, fhi, rhi)
    lo = torch.where(fwd_le, flo, rlo)
    ok &= ~((fhi == rhi) & (flo == rlo))  # drop palindromes (even k only)
    return hi, lo, flag, ok


def rc_code_int64(codes: np.ndarray, k: int) -> np.ndarray:
    """Host: reverse-complement of 2-bit-packed int64 k-mer codes."""
    c = np.asarray(codes, np.int64).copy()
    out = np.zeros_like(c)
    for _ in range(k):
        out = (out << 2) | (3 - (c & 3))
        c >>= 2
    return out
