"""In-memory reference genome.

Ref: src/ngsep/genome/ReferenceGenome.java:38-262 (load from FASTA at
:47-68, base/region access at :97,207-240).  The genome is stored as a
single concatenated int8 code array plus per-sequence offsets — the dense
layout device kernels index with gathers — alongside the name-indexed
QualifiedSequenceList for host-side use.  Device copies are made on the
device the caller names and cached per device.
"""
from __future__ import annotations

import numpy as np
import torch

from .sequences import (
    QualifiedSequence,
    QualifiedSequenceList,
    decode_dna,
)


class ReferenceGenome:
    def __init__(self, sequences: QualifiedSequenceList):
        self.sequences = sequences
        lengths = np.array([len(s) for s in sequences], dtype=np.int64)
        self.offsets = np.zeros(len(sequences) + 1, dtype=np.int64)
        np.cumsum(lengths, out=self.offsets[1:])
        total = int(self.offsets[-1])
        self.concat = np.empty(total, dtype=np.int8)
        for i, s in enumerate(sequences):
            self.concat[self.offsets[i] : self.offsets[i + 1]] = s.codes
        self._device_concat: dict[torch.device, torch.Tensor] = {}
        self._device_packed: dict[torch.device, tuple] = {}
        self._has_n: bool | None = None

    @classmethod
    def load(cls, path: str) -> "ReferenceGenome":
        from ..io.fasta import load_fasta

        return cls(load_fasta(path))

    @property
    def num_sequences(self) -> int:
        return len(self.sequences)

    @property
    def total_length(self) -> int:
        return int(self.offsets[-1])

    def sequence_name(self, idx: int) -> str:
        return self.sequences[idx].name

    def sequence_length(self, idx_or_name) -> int:
        if isinstance(idx_or_name, str):
            idx_or_name = self.sequences.index_of(idx_or_name)
        return int(self.offsets[idx_or_name + 1] - self.offsets[idx_or_name])

    def index_of(self, name: str) -> int:
        return self.sequences.index_of(name)

    def codes(self, seq_idx_or_name, first: int, last: int) -> np.ndarray:
        """Code slice for 1-based inclusive [first, last]."""
        idx = (
            self.sequences.index_of(seq_idx_or_name)
            if isinstance(seq_idx_or_name, str)
            else seq_idx_or_name
        )
        off = self.offsets[idx]
        seq_len = int(self.offsets[idx + 1] - off)
        first = max(1, first)
        last = min(seq_len, last)
        if last < first:
            return np.empty(0, dtype=np.int8)
        return self.concat[off + first - 1 : off + last]

    def reference_string(self, seq, first: int, last: int) -> str:
        return decode_dna(self.codes(seq, first, last))

    def device_concat(self, device) -> torch.Tensor:
        """Concatenated genome codes (int8) on `device`, uploaded once."""
        device = torch.device(device)
        t = self._device_concat.get(device)
        if t is None:
            t = torch.from_numpy(self.concat).to(device)
            self._device_concat[device] = t
        return t

    @property
    def has_n(self) -> bool:
        """True when any in-genome base is non-ACGT.  The tier-1 screen
        skips the per-candidate N-mask gather for clean genomes (the
        out-of-genome tail is masked by position bounds regardless)."""
        if self._has_n is None:
            self._has_n = bool((self.concat >= 4).any())
        return self._has_n

    def device_packed(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """Bit-packed genome for the tier-1 screen on `device`: (packed,
        nmask2) int64 tensors holding uint32 words, where word w holds bases
        concat[16w..16w+15] at 2 bits each (base j at bit 2j) and nmask2
        holds 1 at bit 2j when that base is non-ACGT."""
        device = torch.device(device)
        t = self._device_packed.get(device)
        if t is None:
            G = len(self.concat)
            W = (G + 15) // 16 + 1  # +1: combine reads one word past the end
            c = np.full(W * 16, 4, dtype=np.uint8)
            c[:G] = self.concat.view(np.uint8)
            base = np.where(c < 4, c, 0).astype(np.uint32).reshape(W, 16)
            isn = (c >= 4).astype(np.uint32).reshape(W, 16)
            sh = (2 * np.arange(16, dtype=np.uint32))[None, :]
            packed = np.bitwise_or.reduce(base << sh, axis=1)
            nmask2 = np.bitwise_or.reduce(isn << sh, axis=1)
            t = (
                torch.from_numpy(packed.astype(np.int64)).to(device),
                torch.from_numpy(nmask2.astype(np.int64)).to(device),
            )
            self._device_packed[device] = t
        return t

    def concat_pos(self, seq_idx: int, pos: int) -> int:
        """Map (sequence idx, 1-based pos) to 0-based concatenated coordinate."""
        return int(self.offsets[seq_idx]) + pos - 1

    def split_concat_pos(self, cpos: int) -> tuple[int, int]:
        """Inverse of concat_pos: -> (sequence idx, 1-based pos)."""
        idx = int(np.searchsorted(self.offsets, cpos, side="right")) - 1
        return idx, int(cpos - self.offsets[idx]) + 1
