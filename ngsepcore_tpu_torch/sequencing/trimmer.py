"""Raw read adapter/quality trimming.

Ref: src/ngsep/sequencing/RawReadsTrimmer.java — 3' quality trimming and
adapter removal.  Quality trimming uses the running-sum cutoff approach:
trim the 3' end from the position where cumulative (q - threshold) is
minimal, vectorized over the quality array.  A copy of
ngsepcore_tpu/sequencing/trimmer.py (host numpy).
"""
from __future__ import annotations

import numpy as np

from ..core.degenerate import compile_degenerate
from ..core.sequences import RawRead, qualities_to_phred
from ..io.fastq import FastqFileReader, write_fastq


class RawReadsTrimmer:
    def __init__(
        self,
        min_quality: int = 15,
        min_read_length: int = 40,
        adapters: list[str] | None = None,
    ):
        self.min_quality = min_quality
        self.min_read_length = min_read_length
        self.adapters = adapters or []
        # adapters may carry IUPAC degenerate bases; the reference trims at
        # the first regex hit (RawReadsTrimmer.java:55, DegenerateSequence
        # makeRegularExpression)
        self._adapter_patterns = [compile_degenerate(a) for a in self.adapters]
        self.trimmed_reads = 0
        self.dropped_reads = 0

    def trim_read(self, read: RawRead) -> RawRead | None:
        seq = read.sequence
        qual = read.qualities
        # adapter clip (first occurrence of any adapter)
        cut = len(seq)
        for pat in self._adapter_patterns:
            m = pat.search(seq, 0, cut + len(pat.pattern))
            if m is not None and m.start() < cut:
                cut = m.start()
        if qual:
            q = qualities_to_phred(qual[:cut]).astype(np.int32)
            delta = q - self.min_quality
            # BWA-style: cut at argmin of reversed cumulative sum
            rev_cum = np.cumsum(delta[::-1])[::-1]
            # trim the suffix whose total (q - threshold) is most negative
            i = int(np.argmin(rev_cum))
            if rev_cum[i] < 0:
                cut = min(cut, i)
        if cut < len(seq):
            self.trimmed_reads += 1
        if cut < self.min_read_length:
            self.dropped_reads += 1
            return None
        return RawRead(read.name, seq[:cut], qual[:cut] if qual else None)

    def run(self, input_file: str, output_file: str) -> None:
        out = []
        for read in FastqFileReader(input_file):
            t = self.trim_read(read)
            if t is not None:
                out.append(t)
        write_fastq(out, output_file)
