"""K-mer code extraction and counting on device.

Ref: DNASequence.java:132-178 — `getDNAHash`/`getNextDNAHash` scalar rolling
2-bit hash per position.  Here: one vectorized shift-accumulate over a
(reads, positions) code tensor, all positions at once.  Ref:
KmersExtractor.java:393-426 + ShortArrayDNAKmersMapImpl.java:21,61-68 — Java
counts into a `short[4^k]` under a lock; here each batch is one sort and one
run-length encoding on the device the tensors lie on, and sorted runs merge
in index/kmers_map.py.  Codes use the reference's alphabet order
A=0,C=1,G=2,T=3 (DNASequence.java:33-34).

Same results as ngsepcore_tpu/kernels/kmers.py.  The GPU has native int64,
so codes sort as one key (int32 for k <= 15, int64 above); the two-half
int32 codes stay for the seed index, whose tables are keyed that way.
"""
from __future__ import annotations

import numpy as np
import torch

N_CODE = 4


def _code_dtype(k: int):
    return torch.int32 if k <= 15 else torch.int64


def _window_ok(c: torch.Tensor, lengths: torch.Tensor, k: int, nk: int):
    """(n, nk) bool: the window lies inside the read and holds ACGT only."""
    acgt = (c < 4).to(torch.int32)
    csum = torch.cumsum(acgt, dim=1, dtype=torch.int32)
    zero = torch.zeros((c.shape[0], 1), dtype=torch.int32, device=c.device)
    n_acgt = csum[:, k - 1 :] - torch.cat([zero, csum[:, : nk - 1]], dim=1)
    pos = torch.arange(nk, dtype=torch.int32, device=c.device)[None, :]
    return (n_acgt == k) & (pos + k <= lengths.to(torch.int32)[:, None])


def kmer_codes(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Extract k-mer codes from a padded (n_reads, L) int8 code batch.

    Returns (kcodes, valid):
      kcodes: (n_reads, L-k+1) int32 (k <= 15) or int64 2-bit-packed codes
      valid:  same-shape bool — window fully in-read and free of non-ACGT
              (non-ACGT breaks the rolling window, ref: KmersExtractor /
              DNASequence.java:164-178 semantics).
    """
    n, L = codes.shape
    nk = L - k + 1
    c = codes.to(_code_dtype(k))
    v = torch.where(c < 4, c, 0)
    acc = torch.zeros((n, nk), dtype=c.dtype, device=codes.device)
    for j in range(k):
        acc = acc * 4 + v[:, j : j + nk]
    return acc, _window_ok(c, lengths, k, nk)


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


def kmer_codes_both_strands(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Forward + reverse-complement k-mer codes for a read batch.

    The reference counts each read's k-mers on both strands by default
    (KmersExtractor "both strands").  The reverse-complement code of a
    window is computed arithmetically from the complemented codes read
    right-to-left.  Returns (fwd, rev, valid)."""
    fwd, ok = kmer_codes(codes, lengths, k)
    n, L = codes.shape
    nk = L - k + 1
    c = codes.to(fwd.dtype)
    comp = torch.where(c < 4, 3 - c, 0)
    acc = torch.zeros_like(fwd)
    for j in range(k - 1, -1, -1):
        acc = acc * 4 + comp[:, j : j + nk]
    return fwd, acc, ok


def sort_count_codes(flat_codes: torch.Tensor, valid: torch.Tensor):
    """Sort a flat code vector and run-length-encode it on its device.

    Returns (sorted_unique_codes, counts int32, n_unique): the arrays hold
    exactly the n_unique distinct valid codes (the JAX package pads them to
    the input's length with sentinel/zero entries past n_unique).  This
    replaces the reference's locked scatter into `short[4^k]`
    (ShortArrayDNAKmersMapImpl.java:61-68) with a sort — deterministic and
    parallel with no contention."""
    s = torch.sort(flat_codes[valid]).values
    uniq, counts = torch.unique_consecutive(s, return_counts=True)
    return uniq, counts.to(torch.int32), uniq.shape[0]


def _flat_kmers(codes, lengths, k: int, both_strands: bool):
    if both_strands:
        fwd, rev, ok = kmer_codes_both_strands(codes, lengths, k)
        ok = ok.reshape(-1)
        return torch.cat([fwd.reshape(-1), rev.reshape(-1)]), torch.cat([ok, ok])
    fwd, ok = kmer_codes(codes, lengths, k)
    return fwd.reshape(-1), ok.reshape(-1)


def count_batch_kmers(codes, lengths, k: int, both_strands: bool = True):
    """Full per-batch k-mer counting: extract + sort + RLE on device."""
    return sort_count_codes(*_flat_kmers(codes, lengths, k, both_strands))


def decode_kmer(code: int, k: int) -> str:
    """Decode a 2-bit packed k-mer code back to an ACGT string."""
    out = []
    for _ in range(k):
        out.append("ACGT"[code & 3])
        code >>= 2
    return "".join(reversed(out))


def encode_kmer(kmer: str) -> int:
    code = 0
    for ch in kmer:
        code = code * 4 + "ACGT".index(ch.upper())
    return code
