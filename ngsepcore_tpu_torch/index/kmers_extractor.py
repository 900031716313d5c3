"""KmersExtractor engine — k-mer spectrum from reads or assemblies.

Ref: src/ngsep/sequences/KmersExtractor.java:53-622 (command `KmersExtractor`,
defaults k=15 minCount=5 at :56-57, 100-kbp chunking at :62,379-392, both
strands by default).  Reads stream from FASTA/FASTQ in large batches, get
packed into dense (reads, L) code tensors, and each batch's k-mers are
extracted, sorted and run-length-encoded on the extractor's device
(kernels/kmers.count_batch_kmers); the sorted runs stay there and merge on
the device at the first host access (index/kmers_map.py).  Long sequences
(assemblies) are chunked into windows with a (k-1)-overlap so no
window-spanning k-mer is lost — the analog of MAX_LENGTH_SINGLE_TASK
chunking.  Same map, distribution and files as
ngsepcore_tpu/index/kmers_extractor.py.
"""
from __future__ import annotations


import numpy as np
import torch

from ..core.sequences import pack_reads
from ..io.fasta import FastaFileReader
from ..io.fastq import FastqFileReader
from .kmers_map import KmersMap

DEF_KMER_LENGTH = 15
DEF_MIN_KMER_COUNT = 5
CHUNK = 65536  # window for long sequences (ref chunk: 100000)


class KmersExtractor:
    def __init__(
        self,
        kmer_length: int = DEF_KMER_LENGTH,
        min_kmer_count: int = DEF_MIN_KMER_COUNT,
        only_forward_strand: bool = False,
        batch_size: int = 4096,
        read_pad: int = 256,
        *,
        device,
    ):
        self.device = torch.device(device)
        self.kmer_length = kmer_length
        self.min_kmer_count = min_kmer_count
        self.only_forward_strand = only_forward_strand
        self.batch_size = batch_size
        self.read_pad = read_pad
        self.kmers_map = KmersMap(kmer_length)

    # -- batch device path -------------------------------------------------
    def _count_packed(self, codes: np.ndarray, lengths: np.ndarray) -> None:
        from ..kernels.kmers import count_batch_kmers

        uniq, counts, _ = count_batch_kmers(
            torch.from_numpy(codes).to(self.device),
            torch.from_numpy(lengths).to(self.device),
            self.kmer_length,
            both_strands=not self.only_forward_strand,
        )
        self.kmers_map.merge_batch_device(uniq, counts)

    def process_codes_list(self, code_arrays: list[np.ndarray]) -> None:
        """Count k-mers of raw code arrays (variable length), chunking long ones."""
        k = self.kmer_length
        pending: list[np.ndarray] = []
        for arr in code_arrays:
            if len(arr) <= CHUNK:
                pending.append(arr)
            else:
                step = CHUNK - (k - 1)
                for s in range(0, len(arr) - k + 1, step):
                    pending.append(arr[s : s + CHUNK])
            if len(pending) >= self.batch_size:
                self._flush(pending)
                pending = []
        if pending:
            self._flush(pending)

    def _flush(self, arrays: list[np.ndarray]) -> None:
        # bucket by padded length to bound padding waste
        buckets: dict[int, list[np.ndarray]] = {}
        for a in arrays:
            if len(a) < self.kmer_length:
                continue
            pad = self.read_pad
            L = max(pad, ((len(a) + pad - 1) // pad) * pad)
            buckets.setdefault(L, []).append(a)
        for L, group in sorted(buckets.items()):
            codes, lengths, _ = pack_reads(group, pad_to=L, pad_multiple=self.read_pad)
            self._count_packed(codes, lengths)

    # -- file front-ends ----------------------------------------------------
    def process_file(self, path: str) -> None:
        if _is_fastq(path):
            self.process_fastq(path)
        else:
            self.process_fasta(path)

    def process_fastq(self, path: str) -> None:
        reader = FastqFileReader(path)
        for batch in reader.iter_batches(self.batch_size):
            self.process_codes_list([r.codes for r in batch])

    def process_fasta(self, path: str) -> None:
        arrays = [s.codes for s in FastaFileReader(path)]
        self.process_codes_list(arrays)

    # -- outputs -------------------------------------------------------------
    def count_distribution(self, max_count: int = 200) -> np.ndarray:
        return self.kmers_map.count_distribution(max_count)

    def run(self, input_files: list[str], output_prefix: str, text_output: bool = False) -> None:
        """CLI entry: count k-mers of all inputs, write distribution (+ map)."""
        for f in input_files:
            self.process_file(f)
        dist = self.count_distribution()
        with open(output_prefix + "_kmers_distribution.txt", "w") as fh:
            fh.write("Kmer_frequency\tNumber_of_distinct_kmers\n")
            for c, n in enumerate(dist):
                if c == 0:
                    continue
                fh.write(f"{c}\t{int(n)}\n")
        if text_output:
            with open(output_prefix + "_kmers.txt", "w") as fh:
                self.kmers_map.save_text(fh, self.min_kmer_count)
        else:
            self.kmers_map.save(output_prefix + "_kmers.npz")


def _is_fastq(path: str) -> bool:
    p = path.lower()
    for ext in (".fastq", ".fq", ".fastq.gz", ".fq.gz"):
        if p.endswith(ext):
            return True
    return False
