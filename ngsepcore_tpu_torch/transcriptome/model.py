"""Gene/Transcript model.

Ref: src/ngsep/transcriptome/Gene.java, Transcript.java (559 LoC),
TranscriptSegment.java, Transcriptome.java (599 LoC).  A transcript holds
ordered exon segments with coding status; coordinates are 1-based
inclusive genomic positions.  A copy of ngsepcore_tpu/transcriptome/model.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.regions import GenomicRegion, GenomicRegionSortedCollection

# segment status
UTR5 = "5p_utr"
UTR3 = "3p_utr"
CODING = "coding"
NONCODING = "noncoding"


@dataclass
class TranscriptSegment(GenomicRegion):
    status: str = NONCODING


@dataclass
class Transcript:
    transcript_id: str
    sequence_name: str
    first: int
    last: int
    negative_strand: bool
    gene_id: str | None = None
    segments: list[TranscriptSegment] = field(default_factory=list)

    @property
    def coding(self) -> bool:
        return any(s.status == CODING for s in self.segments)

    def exons_sorted(self) -> list[TranscriptSegment]:
        return sorted(self.segments, key=lambda s: s.first)

    def coding_segments(self) -> list[TranscriptSegment]:
        return [s for s in self.exons_sorted() if s.status == CODING]

    def cds_genomic_positions(self) -> list[int]:
        """Genomic positions of the CDS in translation order (5'->3')."""
        pos = []
        for s in self.coding_segments():
            pos.extend(range(s.first, s.last + 1))
        if self.negative_strand:
            pos.reverse()
        return pos

    def position_in_exon(self, pos: int) -> TranscriptSegment | None:
        for s in self.segments:
            if s.first <= pos <= s.last:
                return s
        return None


@dataclass
class Gene:
    gene_id: str
    name: str | None
    sequence_name: str
    first: int
    last: int
    negative_strand: bool


class Transcriptome:
    def __init__(self):
        self.genes: dict[str, Gene] = {}
        self.transcripts: dict[str, Transcript] = {}
        self._sorted = GenomicRegionSortedCollection()

    def add_gene(self, gene: Gene) -> None:
        self.genes[gene.gene_id] = gene

    def add_transcript(self, t: Transcript) -> None:
        self.transcripts[t.transcript_id] = t
        self._sorted.add(
            GenomicRegion(t.sequence_name, t.first, t.last, t.negative_strand)
        )
        self._regions_by_key = None

    def transcripts_overlapping(
        self, sequence_name: str, first: int, last: int
    ) -> list[Transcript]:
        out = []
        for t in self.transcripts.values():
            if (
                t.sequence_name == sequence_name
                and t.first <= last
                and first <= t.last
            ):
                out.append(t)
        return out

    def __len__(self) -> int:
        return len(self.transcripts)
