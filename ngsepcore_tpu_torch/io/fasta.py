"""FASTA reading/writing (gzip-aware).

Ref: src/ngsep/sequences/io/FastaFileReader.java,
FastaSequencesHandler.java (load/save wrapped FASTA).  Python's gzip module
natively handles multi-member gzip streams, covering the reference's
ConcatGZIPInputStream (ref: src/ngsep/main/io/ConcatGZIPInputStream.java:24-50).
"""
from __future__ import annotations

import gzip
import io
from typing import Iterator, TextIO

from ..core.sequences import QualifiedSequence, QualifiedSequenceList, encode_dna


def _open_text(path: str) -> TextIO:
    """Open a text stream; `-` reads standard input (gzip detected from
    the magic bytes, so `cat reads.fastq.gz | ... -i -` streams too —
    ref: ReadsAligner.java:300-301, KmersExtractor.java:235 pipe support
    via ConcatGZIPInputStream)."""
    if path == "-":
        import sys

        buf = getattr(sys.stdin, "buffer", None)
        if buf is None:
            return sys.stdin  # already a text stream (tests)
        try:
            head = buf.peek(2)[:2] if hasattr(buf, "peek") else b""
        except Exception:
            head = b""
        if head == b"\x1f\x8b":
            return io.TextIOWrapper(gzip.open(buf, "rb"))
        return io.TextIOWrapper(buf)
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "rt")


class FastaFileReader:
    """Streaming FASTA reader yielding QualifiedSequence records."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[QualifiedSequence]:
        name = None
        comments = None
        chunks: list[str] = []
        with _open_text(self.path) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                if line.startswith(">"):
                    if name is not None:
                        yield QualifiedSequence(
                            name=name, codes=encode_dna("".join(chunks)), comments=comments
                        )
                    header = line[1:].strip()
                    parts = header.split(None, 1)
                    name = parts[0]
                    comments = parts[1] if len(parts) > 1 else None
                    chunks = []
                else:
                    chunks.append(line.strip())
        if name is not None:
            yield QualifiedSequence(
                name=name, codes=encode_dna("".join(chunks)), comments=comments
            )


def read_fasta_text(path: str) -> Iterator[tuple[str, str]]:
    """(name, sequence as written) of each record: letters outside ACGT
    (amino acids, IUPAC codes) are kept, not encoded to N."""
    name, chunks = None, []
    with _open_text(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name, chunks = (line[1:].split(None, 1) or [""])[0], []
            elif line:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def load_fasta(path: str) -> QualifiedSequenceList:
    return QualifiedSequenceList(FastaFileReader(path))


def save_fasta(seqs, path_or_fh, line_length: int = 80) -> None:
    """Write sequences in wrapped FASTA (ref: FastaSequencesHandler save)."""
    own = isinstance(path_or_fh, str)
    fh = _open_write(path_or_fh) if own else path_or_fh
    try:
        for s in seqs:
            fh.write(f">{s.name}")
            if s.comments:
                fh.write(f" {s.comments}")
            fh.write("\n")
            chars = s.characters
            for i in range(0, len(chars), line_length):
                fh.write(chars[i : i + line_length])
                fh.write("\n")
    finally:
        if own:
            fh.close()


def _open_write(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "wb"))
    return open(path, "wt")
