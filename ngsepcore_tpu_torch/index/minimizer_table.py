"""Genome minimizer table — the seed index for read mapping.

Ref: src/ngsep/sequences/ShortKmerCodesTable.java:16-420 (window minimizer
selection :261-307, matchCompressed query :344-420).  Minimizers of the
whole genome are selected on the caller's device (kernels/minimizers.py),
then laid out on the host as a CSR structure sorted by k-mer code:

    unique_codes (U,) int64  sorted canonical codes
    row_offsets  (U+1,) int64
    entry_pos    (E,) int64  0-based concatenated genome position
    entry_strand (E,) int8   1 = canonical code is the reverse complement

Overrepresented codes (repeats) are dropped at build time like the
reference's per-code hit cap.  `save`/`load` use the same npz format as
ngsepcore_tpu.index.minimizer_table.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.genome import ReferenceGenome

DEF_KMER_LENGTH = 25  # ref: ReadsAligner.java:62
DEF_WINDOW_LENGTH = 20  # ref: ReadsAligner.java:63
DEF_MAX_HITS_PER_CODE = 500


def _minimizers_compact(mat, lengths, bases, *, k, window):
    """Select minimizers over a (R, chunk) genome-chunk batch and compact
    the selected entries on the tensors' device: returns an (n, 4) int32
    numpy array of [hi, lo, pos, strand] rows."""
    from ..kernels.minimizers import extract_minimizers_canonical

    hi, lo, flag, sel, _valid = extract_minimizers_canonical(
        mat, lengths, k, window
    )
    R, nk = sel.shape
    pos = bases[:, None] + torch.arange(nk, dtype=torch.int32, device=mat.device)
    idx = torch.nonzero(sel.reshape(-1)).squeeze(1)
    lanes = torch.stack(
        [
            hi.reshape(-1)[idx],
            lo.reshape(-1)[idx],
            pos.reshape(-1)[idx],
            flag.reshape(-1)[idx],
        ],
        dim=1,
    )
    return lanes.cpu().numpy()


class MinimizerTable:
    def __init__(
        self,
        k: int = DEF_KMER_LENGTH,
        window: int = DEF_WINDOW_LENGTH,
        max_hits_per_code: int = DEF_MAX_HITS_PER_CODE,
    ):
        self.k = k
        self.window = window
        self.max_hits_per_code = max_hits_per_code
        self.unique_codes = np.empty(0, np.int64)  # canonical codes, sorted
        self.row_offsets = np.zeros(1, np.int64)
        self.entry_pos = np.empty(0, np.int64)  # fwd-genome kmer start
        self.entry_strand = np.empty(0, np.int8)  # 1 = canonical is rc
        self._device_arrays: dict[torch.device, torch.Tensor] = {}

    @classmethod
    def from_arrays(
        cls,
        k: int,
        window: int,
        max_hits_per_code: int,
        unique_codes: np.ndarray,
        row_offsets: np.ndarray,
        entry_pos: np.ndarray,
        entry_strand: np.ndarray,
    ) -> "MinimizerTable":
        """Table over existing CSR arrays (e.g. ngsepcore_tpu's table)."""
        t = cls(int(k), int(window), int(max_hits_per_code))
        t.unique_codes = np.asarray(unique_codes, np.int64)
        t.row_offsets = np.asarray(row_offsets, np.int64)
        t.entry_pos = np.asarray(entry_pos, np.int64)
        t.entry_strand = np.asarray(entry_strand, np.int8)
        return t

    # ---- build -----------------------------------------------------------
    @classmethod
    def build_from_genome(
        cls,
        genome: ReferenceGenome,
        k: int = DEF_KMER_LENGTH,
        window: int = DEF_WINDOW_LENGTH,
        max_hits_per_code: int = DEF_MAX_HITS_PER_CODE,
        *,
        device,
    ) -> "MinimizerTable":
        """One batched pass over the whole genome on `device`: every chunk
        rides one (R, chunk) upload; selection and compaction run there and
        only the selected entries come back."""
        t = cls(k, window, max_hits_per_code)
        lo_bits = 2 * min(k, 15)
        overlap = k + window - 1
        longest = max(
            (len(genome.sequences[si].codes) for si in range(genome.num_sequences)),
            default=0,
        )
        chunk = 1 << 12
        while chunk < min(longest, 1 << 20):
            chunk <<= 1
        rows: list[np.ndarray] = []
        row_base: list[int] = []
        row_len: list[int] = []
        for si in range(genome.num_sequences):
            seq = genome.sequences[si].codes
            base = int(genome.offsets[si])
            L = len(seq)
            step = chunk - overlap
            for s in range(0, max(1, L - k + 1), step):
                piece = seq[s : s + chunk]
                if len(piece) < k:
                    continue
                rows.append(piece)
                row_base.append(base + s)
                row_len.append(len(piece))
        if not rows:
            return t
        R = len(rows)
        mat = np.full((R, chunk), 4, np.int8)
        for i, piece in enumerate(rows):
            mat[i, : len(piece)] = piece
        out = _minimizers_compact(
            torch.from_numpy(mat).to(device),
            torch.tensor(row_len, dtype=torch.int32, device=device),
            torch.tensor(row_base, dtype=torch.int32, device=device),
            k=k,
            window=window,
        )
        hi = out[:, 0].astype(np.int64)
        lo = out[:, 1].astype(np.int64) & 0xFFFFFFFF
        codes = (hi << lo_bits) | lo
        pos = out[:, 2].astype(np.int64)
        strand = out[:, 3].astype(np.int64)
        # dedupe seam duplicates, then CSR by code
        pairs = np.stack([codes, pos, strand], axis=1)
        pairs = np.unique(pairs, axis=0)
        codes, pos, strand = pairs[:, 0], pairs[:, 1], pairs[:, 2]
        order = np.argsort(codes, kind="stable")
        codes, pos, strand = codes[order], pos[order], strand[order]
        starts = np.empty(len(codes), bool)
        starts[0] = True
        np.not_equal(codes[1:], codes[:-1], out=starts[1:])
        uniq = codes[starts]
        offs = np.concatenate([np.nonzero(starts)[0], [len(codes)]]).astype(np.int64)
        counts = np.diff(offs)
        keep_row = counts <= max_hits_per_code
        keep_mask = np.repeat(keep_row, counts)
        t.entry_pos = pos[keep_mask]
        t.entry_strand = strand[keep_mask].astype(np.int8)
        kept_counts = counts[keep_row]
        t.unique_codes = uniq[keep_row]
        t.row_offsets = np.zeros(len(t.unique_codes) + 1, np.int64)
        np.cumsum(kept_counts, out=t.row_offsets[1:])
        return t

    @property
    def size(self) -> int:
        return len(self.entry_pos)

    # tables beyond this many unique codes need the sorted-key layout,
    # which is not part of this slice (ROADMAP.md Queue 1)
    MAX_BUCKETIZED_CODES = 1 << 24
    BUCKET_WIDTH = 8

    def device_arrays(self, device) -> torch.Tensor:
        """Bucketized lookup table on `device` for the seeding kernel,
        built once per device: (NB, 4W + W*KH) int32 rows [hi | lo |
        code-row | cnt | entries].  A query computes bucket = lookup_hash32
        & (NB-1) and gathers one row; NB is sized (and doubled on overflow)
        so every bucket holds <= W codes; exactness comes from the per-slot
        (hi, lo) compare.  Entries carry the genome position with the
        canonical-strand flag in bit 31."""
        device = torch.device(device)
        t = self._device_arrays.get(device)
        if t is None:
            if len(self.unique_codes) > self.MAX_BUCKETIZED_CODES:
                raise NotImplementedError(
                    "sorted-key seed table for genomes over 2^24 distinct "
                    "minimizers: ROADMAP.md Queue 1, \"Sorted-key seed table\""
                )
            t = torch.from_numpy(self._build_bucketized()).to(device)
            self._device_arrays[device] = t
        return t

    def _build_bucketized(self) -> np.ndarray:
        from ..kernels.minimizers import lookup_hash32
        from ..kernels.seeding import SEED_HITS_PER_KMER as KH

        U = len(self.unique_codes)
        if len(self.entry_pos) and int(self.entry_pos.max()) >= (1 << 31):
            raise ValueError("genome too large for int32 seed positions")
        lo_bits = 2 * min(self.k, 15)
        code_hi = (self.unique_codes >> lo_bits).astype(np.int32)
        code_lo = (self.unique_codes & ((1 << lo_bits) - 1)).astype(np.int32)
        h = lookup_hash32(
            torch.from_numpy(code_hi), torch.from_numpy(code_lo)
        ).numpy()
        W = self.BUCKET_WIDTH
        NB = 1 << max(int(U - 1).bit_length(), 4) if U else 16
        while True:
            b = h & (NB - 1)
            order = np.argsort(b, kind="stable")
            bs = b[order]
            # slot within bucket = rank within equal-bucket run
            run_start = np.concatenate([[0], np.nonzero(bs[1:] != bs[:-1])[0] + 1])
            gid = np.zeros(U, np.int64)
            gid[run_start] = 1
            gid = np.cumsum(gid) - 1
            slot = np.arange(U, dtype=np.int64) - run_start[gid]
            if U == 0 or slot.max() < W:
                break
            NB *= 2  # a bucket overflowed (skewed hashes); re-spread
        b_all = np.zeros((NB, 4 * W + W * KH), np.int32)
        b_all[:, :W] = -1
        b_all[:, W : 2 * W] = -1
        counts = np.diff(self.row_offsets)
        if U:
            b_all[bs, slot] = code_hi[order]
            b_all[bs, W + slot] = code_lo[order]
            b_all[bs, 2 * W + slot] = order.astype(np.int32)  # code row
            b_all[bs, 3 * W + slot] = counts[order].astype(np.int32)
        entries = (
            self.entry_pos | (self.entry_strand.astype(np.int64) << 31)
        ).astype(np.uint32).view(np.int32)
        if U:
            take = np.minimum(counts, KH)[order]
            rows = np.repeat(bs, take)
            base = 4 * W + slot * KH
            cols = np.arange(int(take.sum()), dtype=np.int64) - np.repeat(
                np.concatenate([[0], np.cumsum(take)[:-1]]), take
            )
            src = np.repeat(self.row_offsets[:-1][order], take) + cols
            b_all[rows, np.repeat(base, take) + cols] = entries[src]
        return b_all

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            k=self.k,
            window=self.window,
            max_hits=self.max_hits_per_code,
            unique_codes=self.unique_codes,
            row_offsets=self.row_offsets,
            entry_pos=self.entry_pos,
            entry_strand=self.entry_strand,
        )

    @classmethod
    def load(cls, path: str) -> "MinimizerTable":
        d = np.load(path)
        return cls.from_arrays(
            int(d["k"]),
            int(d["window"]),
            int(d["max_hits"]),
            d["unique_codes"],
            d["row_offsets"],
            d["entry_pos"],
            d["entry_strand"]
            if "entry_strand" in d
            else np.zeros(len(d["entry_pos"]), np.int8),
        )
