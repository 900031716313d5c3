"""SAM text I/O (gzip-aware), header with read groups.

Ref: src/ngsep/alignments/io/ReadAlignmentFileReader.java:52-139 (5 load
modes, flag/MQ filters, read-group -> sample map) and
ReadAlignmentFileWriter.java:26-65 (BAM writer with sample/platform read
group).  This host layer replaces htsjdk — the only third-party alignment
dependency the reference has.  Text SAM first; bgzf BAM support can layer
on top of the same record model.
"""
from __future__ import annotations

from typing import Iterator

from ..align.read_alignment import ReadAlignment, cigar_from_string
from ..core.sequences import QualifiedSequenceList
from .fasta import _open_text, _open_write


class ReadAlignmentFileWriter:
    def __init__(
        self,
        sequences: QualifiedSequenceList,
        path_or_fh,
        sample_id: str | None = None,
        platform: str = "ILLUMINA",
        sort_order: str = "unsorted",
    ):
        self._bam = None
        if isinstance(path_or_fh, str) and path_or_fh.endswith(".bam"):
            from .bam import BAMWriter

            self._bam = BAMWriter(
                sequences, path_or_fh, sample_id, platform, sort_order
            )
            return
        self._own = isinstance(path_or_fh, str)
        self.fh = _open_write(path_or_fh) if self._own else path_or_fh
        self.sample_id = sample_id
        self.fh.write(f"@HD\tVN:1.6\tSO:{sort_order}\n")
        for s in sequences:
            self.fh.write(f"@SQ\tSN:{s.name}\tLN:{len(s)}\n")
        if sample_id:
            self.fh.write(f"@RG\tID:{sample_id}\tSM:{sample_id}\tPL:{platform}\n")
        self.fh.write("@PG\tID:ngsepcore_tpu_torch\tPN:ngsepcore_tpu_torch\n")

    def write(self, aln: ReadAlignment) -> None:
        if self._bam is not None:
            self._bam.write(aln)
            return
        if self.sample_id and aln.read_group is None:
            aln.read_group = self.sample_id
        self.fh.write("\t".join(aln.to_sam_fields()))
        self.fh.write("\n")

    def close(self) -> None:
        if self._bam is not None:
            self._bam.close()
        elif self._own:
            self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class ReadAlignmentFileReader:
    """Iterates ReadAlignment records from a SAM(.gz) file.

    Supports the reference's default filters: skip unmapped / secondary /
    failed-QC records, minimum MAPQ (ReadAlignmentFileReader.java:52-56
    load modes + filter flags).
    """

    def __init__(
        self,
        path: str,
        min_mq: int = 0,
        skip_secondary: bool = True,
        skip_unmapped: bool = True,
        region: tuple[str, int, int] | None = None,
    ):
        self.path = path
        self.min_mq = min_mq
        self.skip_secondary = skip_secondary
        self.skip_unmapped = skip_unmapped
        # (seq_name, first, last) 1-based inclusive: restrict iteration to
        # alignments overlapping the region (ref: -querySeq/-first/-last,
        # AlignmentsPileupGenerator.java:310-321).  BAM inputs use the
        # linear index (io.bam.iter_region); SAM text streams filter.
        self.region = region
        self.sequence_names: list[str] = []
        self.sequence_lengths: list[int] = []
        self.read_groups: dict[str, str] = {}  # rg id -> sample

    def _parse_header_line(self, line: str) -> None:
        if line.startswith("@SQ"):
            fields = dict(
                f.split(":", 1) for f in line.rstrip("\n").split("\t")[1:] if ":" in f
            )
            self.sequence_names.append(fields.get("SN", ""))
            self.sequence_lengths.append(int(fields.get("LN", 0)))
        elif line.startswith("@RG"):
            fields = dict(
                f.split(":", 1) for f in line.rstrip("\n").split("\t")[1:] if ":" in f
            )
            self.read_groups[fields.get("ID", "")] = fields.get(
                "SM", fields.get("ID", "")
            )

    def __iter__(self) -> Iterator[ReadAlignment]:
        if self.path.endswith(".bam"):
            from .bam import BAMReader

            r = BAMReader(
                self.path,
                min_mq=self.min_mq,
                skip_secondary=self.skip_secondary,
                skip_unmapped=self.skip_unmapped,
            )
            # share the header containers: BAMReader fills them in place
            # while records stream, so early consumers still see them
            self.sequence_names = r.sequence_names
            self.sequence_lengths = r.sequence_lengths
            self.read_groups = r.read_groups
            if self.region is not None:
                yield from r.iter_region(*self.region)
            else:
                yield from r
            return
        with _open_text(self.path) as fh:
            for line in fh:
                if line.startswith("@"):
                    self._parse_header_line(line)
                    continue
                aln = parse_sam_line(line)
                if aln is None:
                    continue
                if self.skip_unmapped and aln.is_unmapped:
                    continue
                if self.skip_secondary and aln.is_secondary:
                    continue
                if aln.alignment_quality < self.min_mq:
                    continue
                if self.region is not None:
                    rseq, rf, rl = self.region
                    if (
                        aln.sequence_name != rseq
                        or aln.first > rl
                        or aln.last < rf
                    ):
                        continue
                yield aln


def parse_sam_line(line: str) -> ReadAlignment | None:
    f = line.rstrip("\n").split("\t")
    if len(f) < 11:
        return None
    flags = int(f[1])
    rname = f[2] if f[2] != "*" else None
    aln = ReadAlignment(
        sequence_name=rname,
        first=int(f[3]),
        cigar=cigar_from_string(f[5]),
        flags=flags,
        read_name=f[0],
        read_chars=f[9] if f[9] != "*" else "",
        qualities=f[10] if f[10] != "*" else None,
        alignment_quality=int(f[4]),
        mate_sequence_name=None if f[6] == "*" else (rname if f[6] == "=" else f[6]),
        mate_first=int(f[7]),
        inferred_insert_size=int(f[8]),
    )
    for tag in f[11:]:
        if tag.startswith("NM:i:"):
            aln.num_mismatches = int(tag[5:])
        elif tag.startswith("RG:Z:"):
            aln.read_group = tag[5:]
    return aln
