"""Window-minimizer selection on device.

Ref: src/ngsep/sequences/ShortKmerCodesTable.java:261-335 — per window of
`w` consecutive k-mers the k-mer with the smallest hash is selected.

Selection is two sliding reductions over the whole hash tensor at once:
    W[s]   = min(hash[s .. s+w-1])              (window minima)
    sel[i] = ( max_{windows s covering i} W[s] ) == hash[i]
Because W[s] <= hash[i] for every window covering i, position i is a
minimizer of some window iff the max of covering window minima equals its
own hash.

uint32 arithmetic is carried in int64 tensors and masked to 32 bits after
every operation that can leave them (torch has no general uint32 math).
"""
from __future__ import annotations

import numpy as np
import torch

from .kmers import kmer_codes_canonical_2x32

# murmur3-style mixing constants for the two-half hashes
_MIX_A = 0x85EBCA6B
_MIX_B = 0xC2B2AE35
_MIX_C = 0x7FEB352D
_M32 = 0xFFFFFFFF
DEFAULT_HASH_MOD = 1073676287  # ref: ShortKmerCodesTable hash modulus


def default_kmer_hash(codes: torch.Tensor) -> torch.Tensor:
    """(code + 1) % 1073676287, the reference's analyzer-free hash, as
    int32 (the result is below 2^30)."""
    return ((codes.to(torch.int64) + 1) % DEFAULT_HASH_MOD).to(torch.int32)


def minimizer_hash30(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """30-bit selection hash of two-half k-mer codes (int32 result)."""
    h = (hi.to(torch.int64) * _MIX_A + lo.to(torch.int64) * _MIX_B) & _M32
    h = h ^ (h >> 15)
    h = (h * _MIX_C) & _M32
    h = h ^ (h >> 13)
    return (h >> 2).to(torch.int32)  # < 2^30: safe for select_minimizers


def lookup_hash32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Full-width uint32 table key of two-half k-mer codes, as int64.
    Exactness comes from verifying (hi, lo) per query, not from this hash."""
    h = (hi.to(torch.int64) * _MIX_B + lo.to(torch.int64) * _MIX_A) & _M32
    h = h ^ (h >> 16)
    h = (h * _MIX_C) & _M32
    h = h ^ (h >> 15)
    return h


def select_minimizers(hashes: torch.Tensor, valid: torch.Tensor, window: int):
    """Mark minimizer positions in a (B, n_kmers) int32 hash tensor.

    Invalid slots get a large hash so they never win a window; windows
    containing an invalid slot still select among their valid members.
    Returns bool (B, n_kmers)."""
    big = torch.iinfo(torch.int32).max // 2
    h = torch.where(valid, hashes, big)
    B, nk = h.shape
    w = min(window, nk)
    nw = nk - w + 1
    wmin = h[:, 0:nw]
    for j in range(1, w):
        wmin = torch.minimum(wmin, h[:, j : j + nw])
    # max of covering window minima: window s covers i if s in [i-w+1, i];
    # pad so position i sees exactly its covering windows
    pad = torch.full((B, w - 1), -big, dtype=h.dtype, device=h.device)
    wp = torch.cat([pad, wmin, pad], dim=1)
    cover = wp[:, 0:nk]
    for j in range(1, w):
        cover = torch.maximum(cover, wp[:, j : j + nk])
    return (cover == h) & valid


def extract_minimizers_canonical(
    codes: torch.Tensor, lengths: torch.Tensor, k: int, window: int
):
    """codes (B, L) -> (hi, lo, flag, minimizer mask, valid): canonical
    extraction used by BOTH the genome table build and read queries —
    strand-symmetric selection means a read and its mapping locus select
    the same windows regardless of orientation."""
    hi, lo, flag, valid = kmer_codes_canonical_2x32(codes, lengths, k)
    sel = select_minimizers(minimizer_hash30(hi, lo), valid, window)
    return hi, lo, flag, sel, valid


def _forward_codes(hi: np.ndarray, lo: np.ndarray, flag: np.ndarray, k: int) -> np.ndarray:
    """Forward-strand int64 codes from canonical halves and the strand flag."""
    from .kmers import rc_code_int64

    canon = (hi.astype(np.int64) << (2 * min(k, 15))) | lo.astype(np.int64)
    return np.where(flag == 1, rc_code_int64(canon, k), canon)


def extract_minimizers_compact(
    codes: torch.Tensor, lengths: torch.Tensor, k: int, window: int
):
    """codes (B, L) int8 -> host arrays (row int32, pos int32, kcodes int64)
    of the selected minimizer positions only, row-major.  Selection is
    canonical (as in the table build); the codes are forward-strand.  The
    compaction is one torch.nonzero on the tensors' device and one fetch of
    the selected entries."""
    hi, lo, flag, sel, _valid = extract_minimizers_canonical(codes, lengths, k, window)
    nk = sel.shape[1]
    flat = torch.nonzero(sel.reshape(-1)).squeeze(1)
    picked = torch.stack(
        [flat // nk, flat % nk]
        + [t.reshape(-1)[flat].to(torch.int64) for t in (hi, lo, flag)]
    ).cpu().numpy()
    row, pos, h, l, f = picked
    return row.astype(np.int32), pos.astype(np.int32), _forward_codes(h, l, f, k)


def extract_minimizers(codes: torch.Tensor, lengths: torch.Tensor, k: int, window: int):
    """codes (B, L) int8 -> host (kcodes int64 (B, n_kmers), minimizer mask,
    valid): canonical selection, forward-strand codes at every window, so
    host callers keep a forward-coordinate view (MinimizerTable
    .collect_hits re-canonicalizes and strand-filters)."""
    hi, lo, flag, sel, valid = extract_minimizers_canonical(codes, lengths, k, window)
    kcodes = _forward_codes(hi.cpu().numpy(), lo.cpu().numpy(), flag.cpu().numpy(), k)
    return kcodes, sel.cpu().numpy(), valid.cpu().numpy()
