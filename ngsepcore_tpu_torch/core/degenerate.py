"""IUPAC degenerate DNA and amino-acid alphabets.

Ref: src/ngsep/sequences/DegenerateSequence.java:26-160 (15-letter alphabet
"ACMRBDWNSHVYKGT", 2-base IUB codes, 3-base codes BDHV, self-complementary
W/S, regex builder) and AminoacidSequence.java:11-50 (A-Z alphabet, default
'X').

A copy of ngsepcore_tpu/core/degenerate.py (host numpy).  Representation:
a degenerate base is a 4-bit mask (bit b set if
base `ACGT`[b] is represented).  Complement is a vectorized bit-reversal of
the mask; base compatibility (as used in degenerate-adapter matching) is one
`&` per position, so a degenerate pattern can be scanned against a dense
read batch with a single boolean contraction instead of per-char regexes.
"""
from __future__ import annotations

import re

import numpy as np

DNA_BASES = "ACGT"
# 2-base IUB code for bases (i, j): IUB_CODES2[i][j] (ref iubCodes2)
IUB_CODES2 = ["AMRW", "MCSY", "RSGK", "WYKT"]
IUB_CODES3 = "BDHV"  # code at index i = all bases except DNA_BASES[i]
DEGENERATE_ALPHABET = "ACMRBDWNSHVYKGT"  # ref `alphabet`
AMINOACIDS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"  # ref AminoacidSequence.AMINOACIDS

# --- 4-bit mask tables ----------------------------------------------------
# mask bit b (1<<b) <=> base DNA_BASES[b] is represented
_MASKS: dict[str, int] = {}
for _i, _b in enumerate(DNA_BASES):
    _MASKS[_b] = 1 << _i
for _i in range(4):
    for _j in range(4):
        if _i != _j:
            _MASKS[IUB_CODES2[_i][_j]] = (1 << _i) | (1 << _j)
for _i, _c in enumerate(IUB_CODES3):
    _MASKS[_c] = 0b1111 ^ (1 << _i)
_MASKS["N"] = 0b1111

_MASK_TO_CHAR = {v: k for k, v in _MASKS.items()}

_ENC_MASK_TABLE = np.zeros(256, dtype=np.uint8)
for _c, _m in _MASKS.items():
    _ENC_MASK_TABLE[ord(_c)] = _m
    _ENC_MASK_TABLE[ord(_c.lower())] = _m


def encode_degenerate_masks(seq: str | bytes) -> np.ndarray:
    """Sequence -> uint8 4-bit base-mask array (0 for unknown chars)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENC_MASK_TABLE[np.frombuffer(seq, dtype=np.uint8)]


def decode_degenerate_masks(masks: np.ndarray) -> str:
    """4-bit mask array -> IUPAC string ('N' for empty/unknown masks)."""
    return "".join(_MASK_TO_CHAR.get(int(m) & 0b1111, "N") or "N" for m in masks)


def get_extended_bases(base: str) -> str | None:
    """Bases represented by a (possibly degenerate) base (ref :65-91).

    Returns the base itself if plain, the concatenated bases for a
    degenerate code, or None for an unrecognized character."""
    m = _MASKS.get(base)
    if m is None:
        return None
    return "".join(DNA_BASES[b] for b in range(4) if m & (1 << b))


def get_degenerate_base(base1: str, base2: str) -> str:
    """2-base IUB code for two plain bases (ref getDegenerateBase:139-143)."""
    i = DNA_BASES.index(base1)
    j = DNA_BASES.index(base2)
    return IUB_CODES2[i][j]


def degenerate_complement(base: str) -> str:
    """Complement of a possibly-degenerate base (ref getComplement:118-124).

    In mask form the complement reverses the 4 bits (A<->T, C<->G)."""
    m = _MASKS.get(base)
    if m is None:
        return base
    rev = ((m & 1) << 3) | ((m & 2) << 1) | ((m & 4) >> 1) | ((m & 8) >> 3)
    return _MASK_TO_CHAR[rev]


def degenerate_reverse_complement(seq: str) -> str:
    """Reverse complement preserving degenerate codes (ref :96-111)."""
    return "".join(degenerate_complement(c) for c in reversed(seq))


def make_regular_expression(degenerate_seq: str) -> str:
    """Regex equivalent of a degenerate sequence (ref :150-160)."""
    out = []
    for c in degenerate_seq:
        ext = get_extended_bases(c)
        if not ext:
            raise ValueError(
                f"Unrecognized degenerate base {c} in sequence {degenerate_seq}"
            )
        out.append(ext if len(ext) == 1 else "[" + ext + "]")
    return "".join(out)


def compile_degenerate(degenerate_seq: str) -> re.Pattern:
    return re.compile(make_regular_expression(degenerate_seq))


def match_positions(pattern_masks: np.ndarray, read_masks: np.ndarray
                    ) -> np.ndarray:
    """All start offsets where a degenerate pattern matches a read.

    Vectorized mask-AND scan: position p matches iff every pattern slot is
    compatible (shares a base bit) with the read base under it.  Works on a
    single read (1-D)."""
    k = len(pattern_masks)
    n = len(read_masks)
    if n < k:
        return np.empty(0, dtype=np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(read_masks, k)
    ok = ((windows & pattern_masks[None, :]) != 0).all(axis=1)
    return np.nonzero(ok)[0]


# --- amino-acid alphabet --------------------------------------------------
_AA_ENC = np.full(256, AMINOACIDS.index("X"), dtype=np.int8)
for _i, _c in enumerate(AMINOACIDS):
    _AA_ENC[ord(_c)] = _i
    _AA_ENC[ord(_c.lower())] = _i
_AA_DEC = np.frombuffer(AMINOACIDS.encode(), dtype=np.uint8)


def encode_aminoacids(seq: str | bytes) -> np.ndarray:
    """Protein string -> int8 codes 0..25 (unknown chars -> 'X')."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _AA_ENC[np.frombuffer(seq, dtype=np.uint8)]


def decode_aminoacids(codes: np.ndarray) -> str:
    return _AA_DEC[np.asarray(codes, dtype=np.int64)].tobytes().decode("ascii")
