"""K-mer spectrum read error correction.

Ref: src/ngsep/sequences/ReadsFileErrorsCorrector.java:1-443 (command
`ReadsFileErrorsCorrector`): build a k-mer spectrum of the input, then for
each read locate stretches whose k-mers fall below minKmerCount and try
every single-bp substitution in the stretch, keeping the change that
maximizes the summed spectrum counts of the affected k-mers
(processReadBestSNPChange/correctErrors :364-446, up to 3 rounds).

The spectrum is counted on the corrector's device (index/kmers_extractor.py)
and looked up in the vectorized sorted-array KmersMap; the per-read search
is host work, as in ngsepcore_tpu/index/error_correction.py, whose outputs
this module reproduces.
"""
from __future__ import annotations

import numpy as np

from ..core.sequences import RawRead, decode_dna, encode_dna
from ..io.fastq import FastqFileReader, write_fastq
from .kmers_extractor import KmersExtractor
from .kmers_map import KmersMap

DEF_KMER_LENGTH = 15
DEF_MIN_KMER_COUNT = 5


class DeBruijnGraphExplorationMiniAssembler:
    """Best-first walk over the k-mer spectrum graph between two solid
    k-mers (ref: DeBruijnGraphExplorationMiniAssembler.java:6-66): states
    are assembled strings; successors append any base whose closing k-mer
    reaches minKmerCount; priority = longest suffix of the state matching
    a prefix of the destination k-mer; agenda capped at 10,000 states.

    Because the walk can assemble a path SHORTER or LONGER than the
    broken read segment, this corrects indel errors — the spectrum-only
    substitution search cannot."""

    def __init__(self, kmers_map: KmersMap, min_kmer_count: int = 1):
        self.kmers_map = kmers_map
        self.min_kmer_count = min_kmer_count

    def assemble(
        self,
        source_kmer: str,
        dest_kmer: str | None,
        min_assembly_length: int,
        expected_assembly_length: int,
        max_assembly_length: int,
    ) -> str | None:
        import heapq

        k = len(source_kmer)
        if expected_assembly_length < k:
            return None
        counter = 0  # FIFO tie-break like the reference's stable queue
        agenda: list[tuple[int, int, str]] = [
            (-self._score(source_kmer, dest_kmer), counter, source_kmer)
        ]
        while agenda and len(agenda) < 10000:
            _, _, state = heapq.heappop(agenda)
            if dest_kmer is None and len(state) == expected_assembly_length:
                return state
            if (
                dest_kmer is not None
                and len(state) >= min_assembly_length
                and state.endswith(dest_kmer)
            ):
                return state
            if len(state) >= max_assembly_length:
                continue
            kminus1 = state[len(state) - k + 1 :]
            for bp in "ACGT":
                next_kmer = kminus1 + bp
                if self.kmers_map.get_count(next_kmer) >= self.min_kmer_count:
                    counter += 1
                    nxt = state + bp
                    heapq.heappush(
                        agenda,
                        (-self._score(nxt, dest_kmer), counter, nxt),
                    )
        return None

    @staticmethod
    def _score(state: str, dest_kmer: str | None) -> int:
        if dest_kmer is None:
            return 0
        for i in range(len(dest_kmer), 0, -1):
            if state.endswith(dest_kmer[:i]):
                return i
        return 0


class ReadsFileErrorsCorrector:
    def __init__(
        self,
        kmer_length: int = DEF_KMER_LENGTH,
        min_kmer_count: int = DEF_MIN_KMER_COUNT,
        rounds: int = 3,
        algorithm: str = "debruijn",  # the reference's default
        # (ReadsFileErrorsCorrector.java:276 routes processRead to the
        # de-Bruijn exploration); "snp" = best-SNP-change search
        *,
        device,
    ):
        self.device = device
        self.kmer_length = kmer_length
        self.min_kmer_count = min_kmer_count
        self.rounds = rounds
        self.algorithm = algorithm
        self.kmers_map: KmersMap | None = None
        self.corrected_errors = 0
        self.corrected_reads = 0
        self._assembler = None

    # ------------------------------------------------------------------
    def build_kmers_map(self, path: str) -> None:
        ex = KmersExtractor(
            kmer_length=self.kmer_length, only_forward_strand=False,
            device=self.device,
        )
        ex.process_file(path)
        self.kmers_map = ex.kmers_map

    # ------------------------------------------------------------------
    def _read_kmer_codes(self, codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        k = self.kmer_length
        L = len(codes)
        if L < k:
            return np.empty(0, np.int64), np.empty(0, bool)
        n = L - k + 1
        kc = np.zeros(n, np.int64)
        ok = np.ones(n, bool)
        c = codes.astype(np.int64)
        for j in range(k):
            cj = c[j : j + n]
            kc = kc * 4 + np.where(cj < 4, cj, 0)
            ok &= cj < 4
        return kc, ok

    def _segment_score(self, codes: np.ndarray, first: int, last: int) -> float:
        """Sum of spectrum counts of k-mers inside codes[first..last]."""
        seg = codes[first : last + 1]
        kc, ok = self._read_kmer_codes(seg)
        if len(kc) == 0:
            return 0.0
        counts = self.kmers_map.lookup(kc)
        return float(np.sum(np.where(ok, counts, 0)))

    def correct_read_debruijn(self, read: RawRead) -> RawRead:
        """Indel-capable correction via k-mer-graph walks between solid
        k-mers (ref: ReadsFileErrorsCorrector.processReadDeBruijnExploration
        :278-360 — the reference's default algorithm).  Low-count regions
        between two represented k-mers are replaced by the assembled path
        (length may differ: indel errors fixed); an unrepresented tail is
        re-assembled without a destination k-mer."""
        if self._assembler is None:
            self._assembler = DeBruijnGraphExplorationMiniAssembler(
                self.kmers_map, self.min_kmer_count
            )
        k = self.kmer_length
        s = read.sequence
        rq = read.qualities
        codes = encode_dna(s)
        kc, ok = self._read_kmer_codes(codes)
        if len(kc) == 0:
            return read
        counts = np.where(ok, self.kmers_map.lookup(kc), 0)
        out: list[str] = []
        out_q: list[str] = []
        corrections = 0
        last_rep = -1
        i = 0
        n = len(kc)
        while i < n:
            if counts[i] < self.min_kmer_count:
                i += 1
                continue
            next_kmer = s[i : i + k]
            if last_rep >= 0 and last_rep + k < i:
                region_len = i - last_rep - k
                expected = i - last_rep + k
                segment = None
                if expected <= 4 * k:
                    asm = self._assembler.assemble(
                        s[last_rep : last_rep + k], next_kmer,
                        2 * k + 1, expected, expected + 5,
                    )
                    if asm is not None and len(asm) > 2 * k:
                        segment = asm[k:-k]
                if segment is not None:
                    if len(segment) != region_len or segment != s[
                        last_rep + k : i
                    ]:
                        corrections += 1
                    out.append(segment)
                    if rq:
                        if len(segment) == region_len:
                            out_q.append(rq[last_rep + k : i])
                        else:
                            out_q.append("+" * len(segment))
                else:
                    # unassemblable region: appended nothing, mirroring
                    # the reference's null branch
                    # (ReadsFileErrorsCorrector.java:309-326); the drop
                    # only materializes if another region corrects (the
                    # original read is kept when corrections == 0)
                    pass
            out.append(next_kmer)
            if rq:
                out_q.append(rq[i : i + k])
            last_rep = i
            i += k
        if last_rep == -1:
            return read
        if last_rep + k < len(s):
            expected = len(s) - last_rep
            asm = self._assembler.assemble(
                s[last_rep : last_rep + k], None, k + 1, expected, expected
            )
            if asm is not None and len(asm) > k:
                corrections += 1
                out.append(asm[k:])
                if rq:
                    out_q.append("+" * (len(asm) - k))
            else:
                out.append(s[last_rep + k :])
                if rq:
                    out_q.append(rq[last_rep + k :])
        if corrections == 0:
            return read
        self.corrected_errors += corrections
        self.corrected_reads += 1
        return RawRead(
            read.name, "".join(out), "".join(out_q) if rq else None
        )

    def correct_read(self, read: RawRead) -> RawRead:
        codes = encode_dna(read.sequence)
        k = self.kmer_length
        changed_any = False
        for _ in range(self.rounds):
            kc, ok = self._read_kmer_codes(codes)
            if len(kc) == 0:
                break
            counts = np.where(ok, self.kmers_map.lookup(kc), 0)
            represented = counts >= self.min_kmer_count
            # gap regions between represented kmers (ref :376-386)
            gaps = []
            last_rep = -1
            for i in range(len(represented)):
                if represented[i]:
                    if i - 1 != last_rep:
                        gaps.append((last_rep, i))
                    last_rep = i
            gaps.append((last_rep, len(codes)))
            changed = False
            for last_rep, next_rep in gaps:
                first = last_rep + k if last_rep >= 0 else 0
                last = next_rep - 1
                if last < first:
                    continue
                lo = last_rep + 1 if last_rep >= 0 else 0
                best_score = self._segment_score(codes, lo, last)
                best = None
                for i in range(first, last + 1):
                    orig = codes[i]
                    if orig >= 4:
                        continue
                    for b in range(4):
                        if b == orig:
                            continue
                        codes[i] = b
                        s = self._segment_score(codes, lo, last)
                        if s > best_score:
                            best_score = s
                            best = (i, b)
                    codes[i] = orig
                if best is not None:
                    codes[best[0]] = best[1]
                    self.corrected_errors += 1
                    changed = True
            if not changed:
                break
            changed_any = True
        if changed_any:
            self.corrected_reads += 1
            return RawRead(read.name, decode_dna(codes), read.qualities)
        return read

    # ------------------------------------------------------------------
    def run(self, input_file: str, output_file: str) -> None:
        self.build_kmers_map(input_file)
        fn = (
            self.correct_read_debruijn
            if self.algorithm == "debruijn"
            else self.correct_read
        )
        out = []
        for read in FastqFileReader(input_file):
            out.append(fn(read))
        write_fastq(out, output_file)
