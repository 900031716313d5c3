"""FASTQ reading/writing (gzip-aware, batch iteration for device packing).

Ref: src/ngsep/sequences/io/FastqFileReader.java:42-120 (4 load modes,
pluggable sequence class).  Adds `iter_batches` — the batched access
pattern: fixed-size read batches ready to pack into dense code tensors,
replacing the reference's one-task-per-read-object dispatch
(ref: ReadsAligner.java:375-398).
"""
from __future__ import annotations

from typing import Iterator, List

from ..core.sequences import RawRead
from .fasta import _open_text, _open_write


class FastqFileReader:
    LOAD_MODE_FULL = 0
    LOAD_MODE_WITH_NAME = 1
    LOAD_MODE_MINIMAL = 2

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[RawRead]:
        with _open_text(self.path) as fh:
            while True:
                header = fh.readline()
                if not header:
                    break
                header = header.rstrip("\n")
                if not header:
                    continue
                if not header.startswith("@"):
                    raise ValueError(f"malformed FASTQ record header: {header!r}")
                seq = fh.readline().rstrip("\n")
                plus = fh.readline()
                if not plus.startswith("+"):
                    raise ValueError("malformed FASTQ record: missing '+' line")
                qual = fh.readline().rstrip("\n")
                name = header[1:].split()[0] if len(header) > 1 else ""
                yield RawRead(name=name, sequence=seq, qualities=qual)

    def iter_batches(self, batch_size: int) -> Iterator[List[RawRead]]:
        batch: List[RawRead] = []
        for read in self:
            batch.append(read)
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch


def write_fastq(reads, path_or_fh) -> None:
    own = isinstance(path_or_fh, str)
    fh = _open_write(path_or_fh) if own else path_or_fh
    try:
        for r in reads:
            qual = r.qualities if r.qualities else "5" * len(r.sequence)
            fh.write(f"@{r.name}\n{r.sequence}\n+\n{qual}\n")
    finally:
        if own:
            fh.close()
