"""Flat per-sequence alignment table: one array-native view of a sorted
ReadAlignment list, shared by the pileup expansion and the batched indel
genotyper.

Ref: the reference walks one Java object per read per listener event
(AlignmentsPileupGenerator.java:377-403); here every per-alignment
attribute is read exactly once into columnar arrays and all downstream
passes (base-call expansion, spanning-call collection, read_position_at
lookups) are numpy operations over those columns.  The M-run CSR gives a
batched `read_position_at`: runs are (ref_start, read_start, len) sorted
by (alignment, ref_start), so a (alignment, position) query is one
searchsorted over composite keys."""
from __future__ import annotations

import numpy as np


class AlnTable:
    __slots__ = (
        "n", "firsts", "lasts", "lens", "scs", "sce", "ig5", "ig3", "neg",
        "gorder", "run_ref", "run_read", "run_len", "run_aln", "run_keys",
        "codes_flat", "qflat", "off",
    )

    def __init__(self, alns, gorder=None):
        import time as _time

        from ..utils import profiling

        _t0 = _time.perf_counter()
        A = len(alns)
        self.n = A
        if gorder is None:
            gorder = np.arange(A, dtype=np.int64)
        self.gorder = np.asarray(gorder, np.int64)
        self.firsts = np.fromiter((a.first for a in alns), np.int64, A)
        self.lasts = np.fromiter((a.last for a in alns), np.int64, A)
        self.lens = np.fromiter((len(a.read_chars) for a in alns), np.int64, A)
        self.scs = np.fromiter((a.soft_clip_start for a in alns), np.int64, A)
        self.sce = np.fromiter((a.soft_clip_end for a in alns), np.int64, A)
        self.ig5 = np.fromiter(
            (a.bases_to_ignore_start for a in alns), np.int64, A
        )
        self.ig3 = np.fromiter(
            (a.bases_to_ignore_end for a in alns), np.int64, A
        )
        self.neg = np.fromiter(
            ((a.flags >> 4) & 1 for a in alns), np.int8, A
        )  # FLAG_READ_REVERSE = 16
        profiling.add("alntab.cols", _time.perf_counter() - _t0)
        _t0 = _time.perf_counter()
        run_counts = np.empty(A, np.int64)
        runs_all: list = []
        for i, a in enumerate(alns):
            r = a.m_runs()
            run_counts[i] = len(r)
            runs_all.extend(r)
        runs_np = (
            np.array(runs_all, np.int64)
            if runs_all
            else np.empty((0, 3), np.int64)
        )
        self.run_ref = runs_np[:, 0]
        self.run_read = runs_np[:, 1]
        self.run_len = runs_np[:, 2]
        self.run_aln = np.repeat(np.arange(A, dtype=np.int64), run_counts)
        self.run_keys = (self.run_aln << 34) | self.run_ref
        profiling.add("alntab.mruns", _time.perf_counter() - _t0)
        _t0 = _time.perf_counter()
        self.codes_flat = (
            np.concatenate([a.read_codes for a in alns])
            if A
            else np.empty(0, np.int8)
        )
        self.off = np.zeros(A, np.int64)
        np.cumsum(self.lens[:-1], out=self.off[1:])
        # per-base phred qualities; '+' (q=10) when absent, matching
        # ReadAlignment.java:1025 via pileup.expand_alignment_calls
        self.qflat = (
            np.frombuffer(
                "".join(
                    a.qualities if a.qualities else "+" * int(self.lens[i])
                    for i, a in enumerate(alns)
                ).encode("ascii"),
                np.uint8,
            ).astype(np.int16)
            - 33
        )
        profiling.add("alntab.flat", _time.perf_counter() - _t0)

    # ------------------------------------------------------------------
    def read_pos(self, pa: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """Batched ReadAlignment.read_position_at: 0-based read index of
        1-based reference `pos` within alignment `pa`, or -1."""
        qk = (pa << 34) | pos
        j = np.searchsorted(self.run_keys, qk, side="right") - 1
        jc = np.maximum(j, 0)
        ok = (
            (j >= 0)
            & (self.run_aln[jc] == pa)
            & (pos >= self.run_ref[jc])
            & (pos < self.run_ref[jc] + self.run_len[jc])
        )
        return np.where(
            ok, self.run_read[jc] + (pos - self.run_ref[jc]), -1
        )

    # ------------------------------------------------------------------
    def device_calls(self, device):
        """Position-sorted packed base calls of the whole sequence on
        `device` (kernels/genotyping.expand_mrun_calls): uploads the run
        table + flat codes/quals (~2 bytes per call) and expands/sorts
        there.

        Returns {"pos": int32 ascending, "attr": int32, "n": int} tensors
        on `device`, or None when the table is empty."""
        import torch

        from ..kernels.genotyping import expand_mrun_calls

        if len(self.run_len) == 0:
            return None
        # realigner end-trims at run granularity: the [ig5, len-ig3)
        # read-coordinate interval of ReadAlignment.getAlleleCall's
        # basesToIgnore
        lo = self.ig5[self.run_aln]
        hi = (self.lens - self.ig3)[self.run_aln]
        ns = np.maximum(self.run_read, lo)
        delta = ns - self.run_read
        ne = np.minimum(self.run_read + self.run_len, hi)
        ln = ne - ns
        keep = ln > 0
        if not keep.any():
            return None
        run_ref = (self.run_ref + delta)[keep].astype(np.int32)
        run_src = (self.off[self.run_aln] + ns)[keep].astype(np.int32)
        run_len = ln[keep].astype(np.int32)
        run_strand = self.neg[self.run_aln][keep].astype(np.int32)
        total = int(run_len.sum())
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        pos, attr, _ = expand_mrun_calls(
            up(run_ref), up(run_src), up(run_len), up(run_strand),
            up(self.codes_flat), up(self.qflat.astype(np.int8)),
            N=total,
        )
        return {"pos": pos, "attr": attr, "n": total}

    # ------------------------------------------------------------------
    def expand_calls(self):
        """All match-segment base calls as flat (ref_pos 1-based, allele
        code, phred qual, strand) arrays — the columnar equivalent of
        pileup.expand_batch_calls(collect_indels=False), with realigner
        end-trims (ig5/ig3) excluded exactly like
        ReadAlignment.getAlleleCall's basesToIgnore handling."""
        R = len(self.run_len)
        if R == 0:
            z = np.empty(0, np.int64)
            return z, z.astype(np.int8), z.astype(np.int8), z.astype(np.int8)
        # int32 throughout: at ~14M calls per sequence the pass is bound by
        # host memory bandwidth, and every column fits
        rid = np.repeat(
            np.arange(R, dtype=np.int32), self.run_len
        )
        cum = np.zeros(R, np.int32)
        np.cumsum(self.run_len[:-1], out=cum[1:])
        o = np.arange(int(self.run_len.sum()), dtype=np.int32) - cum[rid]
        aid = self.run_aln[rid].astype(np.int32)
        pos = self.run_ref[rid].astype(np.int32) + o
        ri = self.run_read[rid].astype(np.int32) + o
        lo32 = self.ig5.astype(np.int32)
        hi32 = (self.lens - self.ig3).astype(np.int32)
        keep = (ri >= lo32[aid]) & (ri < hi32[aid])
        pos, ri, aid = pos[keep], ri[keep], aid[keep]
        src = self.off[aid].astype(np.int64) + ri
        # pos stays int32: callers sort it (numpy radix-sorts int32 ~6x
        # faster than the int64 mergesort) and positions are per-sequence
        return (
            pos,
            self.codes_flat[src],
            self.qflat[src].astype(np.int8),
            self.neg[aid],
        )
