"""Read demultiplexing by barcodes — single and dual, per-lane, streaming.

Ref: src/ngsep/sequencing/ReadsDemultiplex.java:244-577 (run flow: lane
descriptor group demux, single/paired fastq, stdin; streaming per-sample
gzip writers opened on first read and APPENDED across files of a lane
group; statistics report), BarcodeMap.java:36-140 (single/dual barcode
registration, longest-match lookup with a first-two-nucleotide index),
SequencingLane.java (flowcell+lane key, per-lane barcode map and file
lists), io/BarcodesFileLoader.java (tab-separated index file, header
skipped: flowcell lane barcode [barcode2] sample),
io/LaneFilesLoader.java (descriptor: flowcell lane file1 [file2]).

A copy of ngsepcore_tpu/sequencing/demultiplex.py: demultiplexing is
IO-bound string routing with no dense math, so it stays a streaming host
pass with O(samples) memory (the reference design).
"""
from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field

from ..core.degenerate import compile_degenerate
from ..io.fastq import FastqFileReader


class BarcodeMap:
    """Single- and dual-barcode to sample map with longest-match lookup
    (ref: BarcodeMap.java — one barcode being a prefix of another resolves
    to the longest that matches)."""

    def __init__(self, barcode_to_sample: dict[str, str] | None = None):
        self._map: dict[str, str] = {}
        self._b1: list[str] = []
        self._b2: list[str] = []
        if barcode_to_sample:
            for b, s in barcode_to_sample.items():
                self.add_single_barcode(b, s)

    def add_single_barcode(self, barcode: str, sample_id: str) -> None:
        old = self._map.get(barcode)
        if old is not None and old != sample_id:
            raise ValueError(
                f"Barcode {barcode} already registered with sample {old}"
            )
        self._map[barcode] = sample_id
        self._b1.append(barcode)
        self._b1.sort(key=len, reverse=True)

    def add_dual_barcode(self, b1: str, b2: str, sample_id: str) -> None:
        key = f"{b1}_{b2}"
        old = self._map.get(key)
        if old is not None and old != sample_id:
            raise ValueError(
                f"Barcode pair {b1}-{b2} already registered with sample {old}"
            )
        self._map[key] = sample_id
        if b1 not in self._b1:
            self._b1.append(b1)
            self._b1.sort(key=len, reverse=True)
        if b2 not in self._b2:
            self._b2.append(b2)
            self._b2.sort(key=len, reverse=True)

    def _find(self, seq: str, side: int) -> str | None:
        # longest-first scan == the reference's longest-match resolution
        for b in self._b1 if side == 1 else self._b2:
            if seq.startswith(b):
                return b
        return None

    def match(self, sequence: str) -> tuple[str, str] | None:
        """(barcode, sample) for a single-barcode read, or None."""
        b = self._find(sequence, 1)
        if b is None:
            return None
        s = self._map.get(b)
        return None if s is None else (b, s)

    def match_pair(self, seq1: str, seq2: str) -> tuple[str, str, str] | None:
        """(barcode1, barcode2, sample) for a dual-barcode pair, or None
        (ref: getSampleIdByReadPair)."""
        b1 = self._find(seq1, 1)
        b2 = self._find(seq2, 2)
        if b1 is None or b2 is None:
            return None
        s = self._map.get(f"{b1}_{b2}")
        return None if s is None else (b1, b2, s)


class SequencingLane:
    """One flowcell lane: its barcode map and fastq file list
    (ref: SequencingLane.java)."""

    def __init__(self, flowcell: str, number: str):
        self.flowcell = flowcell
        self.number = number
        self.barcode_map = BarcodeMap()
        self.files_forward: list[str] = []
        self.files_reverse: list[str | None] = []

    @property
    def unique_key(self) -> str:
        return f"{self.flowcell}_{self.number}"

    def add_single_end_file(self, filename: str) -> None:
        self.files_forward.append(filename)
        self.files_reverse.append(None)

    def add_paired_end_files(self, f1: str, f2: str) -> None:
        self.files_forward.append(f1)
        self.files_reverse.append(f2)


_DNA = set("ACGT")


def _check_dna(b: str, line_no: int) -> str:
    if not b or set(b.upper()) - _DNA:
        raise ValueError(
            f"Barcode: {b} at line {line_no} is not a DNA sequence"
        )
    return b.upper()


def load_lanes_index(
    index_file: str, dual_barcode: bool = False
) -> list[SequencingLane]:
    """Tab-separated index with header: flowcell lane barcode [barcode2]
    sample (ref: BarcodesFileLoader.loadMultipleLanes)."""
    lanes: list[SequencingLane] = []
    lane: SequencingLane | None = None
    with open(index_file) as fh:
        next(fh, None)  # header
        for i, line in enumerate(fh, start=1):
            items = line.rstrip("\n").split("\t")
            if len(items) < (5 if dual_barcode else 4):
                continue
            if (
                lane is None
                or lane.flowcell != items[0]
                or lane.number != items[1]
            ):
                lane = SequencingLane(items[0], items[1])
                lanes.append(lane)
            if dual_barcode:
                lane.barcode_map.add_dual_barcode(
                    _check_dna(items[2], i), _check_dna(items[3], i), items[4]
                )
            else:
                lane.barcode_map.add_single_barcode(
                    _check_dna(items[2], i), items[3]
                )
    return lanes


def load_lane_files(descriptor: str, lanes: list[SequencingLane]) -> None:
    """Attach fastq files to lanes: flowcell lane file1 [file2]
    (ref: LaneFilesLoader.loadFiles)."""
    by_key = {lane.unique_key: lane for lane in lanes}
    with open(descriptor) as fh:
        for line in fh:
            items = line.rstrip("\n").split("\t")
            if len(items) < 3:
                continue
            lane = by_key.get(f"{items[0]}_{items[1]}")
            if lane is None:
                continue
            if len(items) < 4 or not items[3]:
                lane.add_single_end_file(items[2])
            else:
                lane.add_paired_end_files(items[2], items[3])


@dataclass
class DemuxStats:
    total: int = 0
    not_found: int = 0
    too_short: int = 0
    per_sample: dict = field(default_factory=dict)

    @property
    def assigned(self) -> int:
        return sum(self.per_sample.values())

    def report(self) -> str:
        lines = ["Demultiplexing report", f"Total fragments\t{self.total}"]
        for s in sorted(self.per_sample):
            lines.append(f"{s}\t{self.per_sample[s]}")
        lines.append(f"Not found\t{self.not_found}")
        lines.append(f"Fragment too short\t{self.too_short}")
        return "\n".join(lines)


class _Writers:
    """Per-sample output streams, opened lazily on first read and closed
    together; a sample seen again in a later file of the lane group
    APPENDS (ref: getOutputStream — FileOutputStream(file, f.exists()))."""

    def __init__(self, out_dir: str | None, prefix: str | None,
                 gzip_out: bool):
        self.out_dir = out_dir
        self.prefix = prefix
        self.gzip_out = gzip_out
        self.streams: dict[str, object] = {}
        self.paths: dict[str, str] = {}

    def path_for(self, sample: str) -> str:
        name = sample + (".fastq.gz" if self.gzip_out else ".fastq")
        if self.prefix and name[0].isdigit():
            name = self.prefix + name
        if self.out_dir:
            name = os.path.join(self.out_dir, name)
        return name

    def get(self, sample: str):
        s = self.streams.get(sample)
        if s is None:
            path = self.path_for(sample)
            mode = "at" if os.path.exists(path) else "wt"
            s = (
                gzip.open(path, mode)
                if self.gzip_out
                else open(path, mode)
            )
            self.streams[sample] = s
            self.paths[sample] = path
        return s

    def close(self) -> None:
        for s in self.streams.values():
            s.close()
        self.streams.clear()


def _write_read(fh, name: str, seq: str, qual: str | None) -> None:
    fh.write(f"@{name}\n{seq}\n+\n{qual or '5' * len(seq)}\n")


class ReadsDemultiplex:
    """Single/dual-barcode, single/paired-end lane demultiplexer with
    streaming per-sample writers — memory is O(samples), not O(reads)
    (ref: ReadsDemultiplex.java:244 run flow)."""

    def __init__(
        self,
        barcode_map: BarcodeMap | None = None,
        trim_barcode: bool = True,
        min_read_length: int = 40,
        adapter: str | None = None,
        trim_sequences: list[str] | None = None,
        dual_barcode: bool = False,
        out_directory: str | None = None,
        prefix: str | None = None,
        uncompressed_output: bool = False,
    ):
        self.barcode_map = barcode_map
        self.trim_barcode = trim_barcode
        self.min_read_length = min_read_length
        self.dual_barcode = dual_barcode
        self.out_directory = out_directory
        self.prefix = prefix
        self.uncompressed_output = uncompressed_output
        # trim sequences may carry IUPAC degenerate bases (ref
        # ReadsDemultiplex.java:174 compiles them to regexes); the first
        # matching pattern wins per read
        seqs = list(trim_sequences or [])
        if adapter:
            seqs.append(adapter)
        self._trim_patterns = [compile_degenerate(s) for s in seqs]
        self.stats = DemuxStats()
        self.progress_notifier = None

    # ------------------------------------------------------------------
    def demultiplex_lanes(self, lanes: list[SequencingLane]):
        """Demultiplex every file of every lane (ref: demultiplexGroup).
        Writers persist across a lane's files so per-sample outputs of a
        lane group append into one file set."""
        paths = {}
        for lane in lanes:
            self.barcode_map = lane.barcode_map
            for f1, f2 in zip(lane.files_forward, lane.files_reverse):
                if f2 is None:
                    paths.update(self.demultiplex_file(f1, None))
                else:
                    paths.update(self.demultiplex_paired(f1, f2))
        return paths

    # ------------------------------------------------------------------
    def _trim(self, seq: str, qual: str | None):
        for pat in self._trim_patterns:
            m = pat.search(seq)
            if m is not None:
                seq = seq[: m.start()]
                qual = qual[: m.start()] if qual else None
                break
        return seq, qual

    def demultiplex_file(
        self, fastq_path: str, out_prefix: str | None = None,
        gzip_out: bool | None = None,
    ):
        """Split one single-end lane fastq into per-sample streams.
        `out_prefix`/`gzip_out` keep the legacy call shape (prefix mode
        writes <prefix>_<sample>.fastq[.gz])."""
        if gzip_out is None:
            gzip_out = not self.uncompressed_output
        w = self._writers(out_prefix, gzip_out)
        self.stats = DemuxStats()
        st = self.stats
        from ..utils.progress import check as progress_check

        for i, read in enumerate(FastqFileReader(fastq_path)):
            if (i % 10000) == 0:
                progress_check(self.progress_notifier, i // 10000)
            st.total += 1
            m = self.barcode_map.match(read.sequence)
            if m is None:
                st.not_found += 1
                continue
            barcode, sample = m
            seq = read.sequence
            qual = read.qualities
            if self.trim_barcode:
                seq = seq[len(barcode) :]
                qual = qual[len(barcode) :] if qual else None
            seq, qual = self._trim(seq, qual)
            if len(seq) < self.min_read_length:
                st.too_short += 1
                continue
            st.per_sample[sample] = st.per_sample.get(sample, 0) + 1
            _write_read(w.get(sample), read.name, seq, qual)
        w.close()
        return dict(w.paths)

    def demultiplex_paired(
        self, fastq1: str, fastq2: str, out_prefix: str | None = None,
        gzip_out: bool | None = None,
    ):
        """Paired-end demux: dual barcodes look up (read1, read2) prefix
        pairs; read2 is trimmed to read1's post-adapter length
        (ref: demultiplexReadPair)."""
        if gzip_out is None:
            gzip_out = not self.uncompressed_output
        w1 = self._writers(out_prefix, gzip_out, suffix="_1")
        w2 = self._writers(out_prefix, gzip_out, suffix="_2")
        self.stats = DemuxStats()
        st = self.stats
        from ..utils.progress import check as progress_check

        it2 = iter(FastqFileReader(fastq2))
        for i, r1 in enumerate(FastqFileReader(fastq1)):
            r2 = next(it2, None)
            if r2 is None:
                break
            if (i % 10000) == 0:
                progress_check(self.progress_notifier, i // 10000)
            st.total += 1
            if self.dual_barcode:
                m = self.barcode_map.match_pair(r1.sequence, r2.sequence)
                if m is None:
                    st.not_found += 1
                    continue
                b1, b2, sample = m
            else:
                m = self.barcode_map.match(r1.sequence)
                if m is None:
                    st.not_found += 1
                    continue
                b1, sample = m
                b2 = ""
            s1, q1 = r1.sequence, r1.qualities
            s2, q2 = r2.sequence, r2.qualities
            if self.trim_barcode:
                s1 = s1[len(b1) :]
                q1 = q1[len(b1) :] if q1 else None
                if b2:
                    s2 = s2[len(b2) :]
                    q2 = q2[len(b2) :] if q2 else None
            l1 = len(s1)
            s1, q1 = self._trim(s1, q1)
            if len(s1) != l1:  # adapter found: trim the mate to match
                s2 = s2[: len(s1)]
                q2 = q2[: len(s1)] if q2 else None
            if len(s1) < self.min_read_length:
                st.too_short += 1
                continue
            st.per_sample[sample] = st.per_sample.get(sample, 0) + 1
            _write_read(w1.get(sample), r1.name, s1, q1)
            _write_read(w2.get(sample), r2.name, s2, q2)
        w1.close()
        w2.close()
        return {s: (w1.paths[s], w2.paths[s]) for s in w1.paths}

    # ------------------------------------------------------------------
    def _writers(self, out_prefix, gzip_out, suffix: str = ""):
        if out_prefix is not None:
            # legacy prefix mode: <prefix>_<sample><suffix>.fastq[.gz]
            w = _Writers(None, None, gzip_out)
            w.path_for = (
                lambda sample, p=out_prefix, sx=suffix, gz=gzip_out: (
                    f"{p}_{sample}{sx}" + (".fastq.gz" if gz else ".fastq")
                )
            )
            return w
        w = _Writers(self.out_directory, self.prefix, gzip_out)
        if suffix:
            orig = w.path_for
            w.path_for = lambda sample, sx=suffix: orig(sample + sx)
        return w


def load_barcode_file(path: str) -> dict[str, str]:
    """Simple barcode file: <barcode><TAB><sampleId> per line."""
    out = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2 and not line.startswith("#"):
                out[parts[0].upper()] = parts[1]
    return out
