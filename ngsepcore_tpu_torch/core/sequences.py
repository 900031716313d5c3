"""Core sequence model: dense integer-coded DNA on numpy, TPU-ready packing.

Replaces the reference's object-per-sequence model
(ref: src/ngsep/sequences/AbstractLimitedSequence.java:32-442,
DNASequence.java:28-180, QualifiedSequenceList.java, RawRead.java) with flat
numpy int8 code arrays.  Codes: A=0 C=1 G=2 T=3 (matching the reference's
2-bit alphabet order, ref: DNASequence.java:33-34) and 4 = N/any non-ACGT.
All device compute consumes these code arrays; strings only exist at the I/O
boundary.
"""
from __future__ import annotations

import numpy as np
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Sequence

DNA_ALPHABET = "ACGT"
N_CODE = np.int8(4)

# char -> code lookup covering the full byte range; lowercase maps like upper
_ENC_TABLE = np.full(256, 4, dtype=np.int8)
for _i, _c in enumerate(DNA_ALPHABET):
    _ENC_TABLE[ord(_c)] = _i
    _ENC_TABLE[ord(_c.lower())] = _i

_DEC_TABLE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# lowercase mask support (DNAMaskedSequence analog): table of "is lowercase acgtn"
_LOWER_TABLE = np.zeros(256, dtype=bool)
for _c in "acgtn":
    _LOWER_TABLE[ord(_c)] = True


def encode_dna(seq: str | bytes) -> np.ndarray:
    """Encode a DNA string to int8 codes (A=0,C=1,G=2,T=3, other=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _ENC_TABLE[raw]


def lowercase_mask(seq: str | bytes) -> np.ndarray:
    """Boolean mask of softmasked (lowercase) positions (DNAMaskedSequence analog)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _LOWER_TABLE[raw]


def decode_dna(codes: np.ndarray) -> str:
    """Decode int8 codes back to an ACGTN string."""
    codes = np.asarray(codes)
    return _DEC_TABLE[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def reverse_complement_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement on code arrays; N (4) stays N."""
    comp = np.where(codes < 4, 3 - codes, codes)
    return comp[::-1].copy()


def reverse_complement(seq: str) -> str:
    return decode_dna(reverse_complement_codes(encode_dna(seq)))


def qualities_to_phred(qual: str | bytes, offset: int = 33) -> np.ndarray:
    """ASCII quality string -> int8 phred scores."""
    if isinstance(qual, str):
        qual = qual.encode("ascii")
    return (np.frombuffer(qual, dtype=np.uint8).astype(np.int16) - offset).astype(
        np.int8
    )


def phred_to_qualities(phred: np.ndarray, offset: int = 33) -> str:
    return (np.asarray(phred, dtype=np.int16) + offset).astype(np.uint8).tobytes().decode(
        "ascii"
    )


def pack_reads(
    seqs: Sequence[np.ndarray],
    quals: Sequence[np.ndarray] | None = None,
    pad_to: int | None = None,
    pad_multiple: int = 128,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Pack variable-length code arrays into a dense (n, L) batch.

    Pads with N_CODE to a lane-aligned length (multiple of 128 by default so
    the last axis tiles cleanly onto the TPU VPU).  Returns (codes, lengths,
    quals_or_None).  This is the fixed-shape replacement for the reference's
    per-read object traversal (ref: ReadsAligner.java:375-398 one task per
    read object).
    """
    n = len(seqs)
    maxlen = max((len(s) for s in seqs), default=0)
    if pad_to is not None:
        maxlen = max(maxlen, pad_to)
    maxlen = max(pad_multiple, ((maxlen + pad_multiple - 1) // pad_multiple) * pad_multiple)
    codes = np.full((n, maxlen), N_CODE, dtype=np.int8)
    lengths = np.zeros(n, dtype=np.int32)
    qarr = None
    if quals is not None:
        qarr = np.zeros((n, maxlen), dtype=np.int8)
    L0 = len(seqs[0]) if n else 0
    nz = n
    while nz and len(seqs[nz - 1]) == 0:
        nz -= 1
    if quals is None and nz and L0 and all(len(s) == L0 for s in seqs[:nz]):
        # constant length up to trailing empty pad rows (the common case):
        # one C-level concat instead of a per-row Python assignment loop
        codes[:nz, :L0] = np.concatenate(seqs[:nz]).reshape(nz, L0)
        lengths[:nz] = L0
        return codes, lengths, qarr
    for i, s in enumerate(seqs):
        L = len(s)
        codes[i, :L] = s
        lengths[i] = L
        if quals is not None:
            qarr[i, :L] = quals[i][:L]
    return codes, lengths, qarr


@dataclass
class QualifiedSequence:
    """Named sequence with optional qualities/comments.

    Ref: src/ngsep/sequences/QualifiedSequence.java.  The sequence is stored
    as an int8 code array, not a string.
    """

    name: str
    codes: np.ndarray
    qualities: np.ndarray | None = None
    comments: str | None = None

    def __len__(self) -> int:
        return len(self.codes)

    @property
    def length(self) -> int:
        return len(self.codes)

    @property
    def characters(self) -> str:
        return decode_dna(self.codes)

    @classmethod
    def from_string(
        cls, name: str, seq: str, qualities: str | None = None, comments: str | None = None
    ) -> "QualifiedSequence":
        q = qualities_to_phred(qualities) if qualities is not None else None
        return cls(name=name, codes=encode_dna(seq), qualities=q, comments=comments)


class QualifiedSequenceList:
    """Name-indexed list of QualifiedSequence enforcing unique names.

    Ref: src/ngsep/sequences/QualifiedSequenceList.java:1-308.
    """

    def __init__(self, seqs: Iterable[QualifiedSequence] = ()):  # noqa: D401
        self._seqs: list[QualifiedSequence] = []
        self._index: dict[str, int] = {}
        for s in seqs:
            self.add(s)

    def add(self, seq: QualifiedSequence) -> int:
        if seq.name in self._index:
            raise ValueError(f"duplicate sequence name: {seq.name}")
        self._index[seq.name] = len(self._seqs)
        self._seqs.append(seq)
        return len(self._seqs) - 1

    def index_of(self, name: str) -> int:
        return self._index.get(name, -1)

    def get(self, name: str) -> QualifiedSequence | None:
        i = self._index.get(name)
        return self._seqs[i] if i is not None else None

    def names(self) -> list[str]:
        return [s.name for s in self._seqs]

    def __iter__(self) -> Iterator[QualifiedSequence]:
        return iter(self._seqs)

    def __len__(self) -> int:
        return len(self._seqs)

    def __getitem__(self, i: int) -> QualifiedSequence:
        return self._seqs[i]


@dataclass
class RawRead:
    """A FASTQ record (ref: src/ngsep/sequences/RawRead.java:1-111)."""

    name: str
    sequence: str
    qualities: str | None = None
    _codes: np.ndarray | None = field(default=None, repr=False, compare=False)

    def __len__(self) -> int:
        return len(self.sequence)

    @property
    def codes(self) -> np.ndarray:
        if self._codes is None:
            self._codes = encode_dna(self.sequence)
        return self._codes

    @property
    def phred(self) -> np.ndarray | None:
        return qualities_to_phred(self.qualities) if self.qualities else None

    def reverse_complement(self) -> "RawRead":
        rq = self.qualities[::-1] if self.qualities else None
        return RawRead(self.name, reverse_complement(self.sequence), rq)


class ReadBlock:
    """Dense batch of reads — the TPU-native read container.

    One (n, Lp) int8 code matrix + (n,) int32 lengths + optional (n, Lp)
    uint8 ASCII quality matrix (lanes past each read's length hold 0) +
    optional per-read names.  IO readers and simulators emit blocks
    directly so the hot pipeline never touches per-read Python objects
    (this host has 2 vCPUs; building 300k RawRead objects costs ~1s);
    RawRead views are materialized lazily only for reads that drop to
    host-object code paths (a few percent)."""

    __slots__ = ("codes", "lengths", "quals", "names", "default_quality")

    def __init__(self, codes, lengths, quals=None, names=None,
                 default_quality: int = 20):
        self.codes = codes
        self.lengths = lengths
        self.quals = quals
        self.names = names
        self.default_quality = default_quality

    def __len__(self) -> int:
        return self.codes.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return ReadBlock(
                self.codes[i], self.lengths[i],
                None if self.quals is None else self.quals[i],
                None if self.names is None else self.names[i],
                self.default_quality,
            )
        L = int(self.lengths[i])
        c = np.ascontiguousarray(self.codes[i, :L])
        if self.quals is not None:
            q = self.quals[i, :L].tobytes().decode("ascii")
        else:
            q = chr(33 + self.default_quality) * L
        name = self.names[i] if self.names is not None else f"read_{i}"
        return RawRead(name=name, sequence=decode_dna(c), qualities=q, _codes=c)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    @staticmethod
    def concatenate(blocks: "list[ReadBlock]") -> "ReadBlock":
        Lp = max(b.codes.shape[1] for b in blocks)
        codes = np.full((sum(len(b) for b in blocks), Lp), N_CODE, np.int8)
        r = 0
        for b in blocks:
            codes[r : r + len(b), : b.codes.shape[1]] = b.codes
            r += len(b)
        lengths = np.concatenate([b.lengths for b in blocks])
        # blocks lacking quality matrices carry an implicit per-block
        # default_quality; when those defaults differ, materialize explicit
        # quality rows so no read's quality is silently misquoted
        defaults = {b.default_quality for b in blocks if b.quals is None}
        if all(b.quals is not None for b in blocks) or len(defaults) > 1:
            quals = np.zeros((len(lengths), Lp), np.uint8)
            r = 0
            for b in blocks:
                n = len(b)
                if b.quals is not None:
                    quals[r : r + n, : b.quals.shape[1]] = b.quals
                else:
                    qb = 33 + min(b.default_quality, 93)
                    cols = np.arange(Lp, dtype=np.int32)[None, :]
                    quals[r : r + n] = np.where(
                        cols < b.lengths[:, None], qb, 0
                    ).astype(np.uint8)
                r += n
        else:
            quals = None
        if all(b.names is not None for b in blocks):
            names = [n for b in blocks for n in b.names]
        else:
            names = None
        return ReadBlock(codes, lengths, quals, names,
                         blocks[0].default_quality)


# --- distances (ref: sequences/HammingSequenceDistanceMeasure.java,
#     SimpleEditDistanceMeasure.java) -------------------------------------

def hamming_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Hamming distance between equal-length code arrays."""
    if len(a) != len(b):
        raise ValueError("hamming distance requires equal lengths")
    return int(np.count_nonzero(a != b))


def hamming_consensus(strings: list[np.ndarray]) -> np.ndarray:
    """Per-column majority consensus of equal-length code arrays.

    Used for allele-call clustering (ref: AlleleCallClustersBuilder.java:72
    length-partition + Hamming consensus).
    """
    mat = np.stack(strings)
    counts = np.zeros((mat.shape[1], 5), dtype=np.int32)
    for c in range(5):
        counts[:, c] = np.sum(mat == c, axis=0)
    return np.argmax(counts, axis=1).astype(np.int8)


def edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Levenshtein distance (host-side, small strings only).

    Ref: sequences/SimpleEditDistanceMeasure.java.
    """
    la, lb = len(a), len(b)
    prev = np.arange(lb + 1, dtype=np.int32)
    for i in range(1, la + 1):
        cur = np.empty(lb + 1, dtype=np.int32)
        cur[0] = i
        sub = prev[:-1] + (a[i - 1] != b)
        np.minimum(sub, prev[1:] + 1, out=cur[1:])
        for j in range(1, lb + 1):  # carry insertions left-to-right
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev = cur
    return int(prev[lb])
