"""The port's reads processing against the JAX package on the CPU (ROADMAP.md
item 17d): demultiplexing, trimming and the degenerate alphabets.

The cases of tests/test_demultiplex.py (6), tests/test_degenerate.py (8)
and the barcode and trimmer cases of tests/test_reads_processing.py run
through both packages with the JAX tests' checks on the port's side.
Every output is text or an integer array: barcode matches, lane indexes,
the statistics report, each demultiplexed file (gzip files compared
decompressed, since their header holds a time stamp), trimmed reads,
masks, regular expressions and amino-acid codes are held equal to the
JAX package's exactly."""
import gzip
import os

import numpy as np
import pytest

import ngsepcore_tpu.core.degenerate as jdeg
import ngsepcore_tpu.core.sequences as jseq
import ngsepcore_tpu.io.fastq as jfq
import ngsepcore_tpu.sequencing.demultiplex as jdx
import ngsepcore_tpu.sequencing.trimmer as jtrim
import ngsepcore_tpu_torch.core.degenerate as tdeg
import ngsepcore_tpu_torch.core.sequences as tseq
import ngsepcore_tpu_torch.io.fastq as tfq
import ngsepcore_tpu_torch.sequencing.demultiplex as tdx
import ngsepcore_tpu_torch.sequencing.trimmer as ttrim

J = dict(dx=jdx, trim=jtrim, seq=jseq, fq=jfq, deg=jdeg)
T = dict(dx=tdx, trim=ttrim, seq=tseq, fq=tfq, deg=tdeg)


def _fastq(path, reads):
    with open(path, "w") as fh:
        for name, seq in reads:
            fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


def _read_fastq_gz(path):
    with gzip.open(path, "rt") as fh:
        lines = fh.read().splitlines()
    return [(lines[i][1:], lines[i + 1]) for i in range(0, len(lines), 4)]


def _files(d):
    """{name: text} of every file under d (gzip files decompressed)."""
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        opener = gzip.open if name.endswith(".gz") else open
        with opener(path, "rt") as fh:
            out[name] = fh.read()
    return out


def _in_both(tmp_path, run):
    """run(package, its own output directory) for each package; the
    directories' files and the returned values must be equal."""
    got = {}
    for tag, P in (("j", J), ("t", T)):
        d = tmp_path / tag
        d.mkdir()
        got[tag] = (run(P, d), _files(d))
    assert got["t"][1] == got["j"][1]
    assert got["t"][0] == got["j"][0]
    return got["t"][0], tmp_path / "t"


# ---- tests/test_demultiplex.py --------------------------------------------

def test_longest_barcode_wins_equal_jax(tmp_path):
    def run(P, d):
        bm = P["dx"].BarcodeMap()
        bm.add_single_barcode("ACGT", "s1")
        bm.add_single_barcode("ACGTTT", "s2")
        return [bm.match(s) for s in ("ACGTTTAAAA", "ACGTAAAA", "TTTTAAAA")]

    got, _ = _in_both(tmp_path, run)
    assert got == [("ACGTTT", "s2"), ("ACGT", "s1"), None]


def test_dual_barcode_pairs_equal_jax(tmp_path):
    def run(P, d):
        bm = P["dx"].BarcodeMap()
        bm.add_dual_barcode("ACGT", "GGCC", "sA")
        bm.add_dual_barcode("ACGT", "TTAA", "sB")
        out = [bm.match_pair("ACGTAAAA", "GGCCAAAA"), bm.match_pair("ACGTAAAA", "TTAAAAAA")]
        bm.add_dual_barcode("CCCC", "GGCC", "sC")
        return out + [bm.match_pair("CCCCAAAA", "TTAAAAAA")]

    got, _ = _in_both(tmp_path, run)
    assert got == [("ACGT", "GGCC", "sA"), ("ACGT", "TTAA", "sB"), None]


def test_lane_index_and_descriptor_equal_jax(tmp_path):
    idx = tmp_path / "index.txt"
    idx.write_text("flowcell\tlane\tbarcode\tsample\n"
                   "FC1\t1\tACGT\ts1\nFC1\t1\tGGGG\ts2\nFC2\t3\tTTTT\ts3\n")
    f1, f2 = tmp_path / "l1.fastq", tmp_path / "l2.fastq"
    _fastq(f1, [("r1", "ACGT" + "A" * 20), ("r2", "GGGG" + "C" * 20)])
    _fastq(f2, [("r3", "ACGT" + "G" * 20)])
    desc = tmp_path / "lanes.txt"
    desc.write_text(f"FC1\t1\t{f1}\nFC1\t1\t{f2}\nFC9\t9\tmissing.fastq\n")

    def run(P, d):
        lanes = P["dx"].load_lanes_index(str(idx), dual_barcode=False)
        P["dx"].load_lane_files(str(desc), lanes)
        dm = P["dx"].ReadsDemultiplex(min_read_length=10, out_directory=str(d))
        dm.demultiplex_lanes(lanes[:1])
        return [l.unique_key for l in lanes], lanes[0].files_forward, dm.stats.report()

    (keys, files, _), d = _in_both(tmp_path, run)
    assert keys == ["FC1_1", "FC2_3"] and files == [str(f1), str(f2)]
    s1 = _read_fastq_gz(str(d / "s1.fastq.gz"))
    assert [n for n, _ in s1] == ["r1", "r3"] and s1[0][1] == "A" * 20
    assert [n for n, _ in _read_fastq_gz(str(d / "s2.fastq.gz"))] == ["r2"]


def test_paired_dual_barcode_demux_equal_jax(tmp_path):
    idx = tmp_path / "index.txt"
    idx.write_text("flowcell\tlane\tb1\tb2\tsample\n"
                   "FC1\t1\tACGT\tGGCC\tsA\nFC1\t1\tACGT\tTTAA\tsB\n")
    r1, r2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
    _fastq(r1, [("p1", "ACGT" + "A" * 30), ("p2", "ACGT" + "C" * 30), ("p3", "NNNN" + "G" * 30)])
    _fastq(r2, [("p1", "GGCC" + "T" * 30), ("p2", "TTAA" + "G" * 30), ("p3", "GGCC" + "A" * 30)])

    def run(P, d):
        lanes = P["dx"].load_lanes_index(str(idx), dual_barcode=True)
        dm = P["dx"].ReadsDemultiplex(dual_barcode=True, min_read_length=10,
                                      out_directory=str(d))
        dm.barcode_map = lanes[0].barcode_map
        paths = dm.demultiplex_paired(str(r1), str(r2))
        return sorted(paths), dm.stats.not_found, dm.stats.total, dm.stats.report()

    (samples, not_found, total, _), d = _in_both(tmp_path, run)
    assert samples == ["sA", "sB"] and not_found == 1 and total == 3
    assert _read_fastq_gz(str(d / "sA_1.fastq.gz")) == [("p1", "A" * 30)]
    assert _read_fastq_gz(str(d / "sA_2.fastq.gz")) == [("p1", "T" * 30)]
    assert _read_fastq_gz(str(d / "sB_1.fastq.gz")) == [("p2", "C" * 30)]


def test_adapter_trims_mate_to_length_equal_jax(tmp_path):
    a1, a2 = tmp_path / "a1.fastq", tmp_path / "a2.fastq"
    _fastq(a1, [("x", "ACGT" + "A" * 12 + "CCCCC" + "T" * 5)])
    _fastq(a2, [("x", "G" * 26)])

    def run(P, d):
        dm = P["dx"].ReadsDemultiplex(
            P["dx"].BarcodeMap({"ACGT": "s"}), min_read_length=5, adapter="CCCCC",
            out_directory=str(d), uncompressed_output=True)
        paths = dm.demultiplex_paired(str(a1), str(a2))
        return [os.path.basename(p) for p in paths["s"]]

    names, d = _in_both(tmp_path, run)
    assert open(d / names[0]).read().splitlines()[1] == "A" * 12
    assert open(d / names[1]).read().splitlines()[1] == "G" * 12


def test_stats_report_equal_jax(tmp_path):
    f = tmp_path / "l.fastq"
    _fastq(f, [("a", "ACGT" + "A" * 30), ("b", "TTTT" + "A" * 30), ("c", "ACGT" + "A" * 3)])

    def run(P, d):
        dm = P["dx"].ReadsDemultiplex(P["dx"].BarcodeMap({"ACGT": "s1"}), min_read_length=10,
                                      out_directory=str(d))
        dm.demultiplex_file(str(f))
        return dm.stats.report()

    rep, _ = _in_both(tmp_path, run)
    for line in ("Total fragments\t3", "s1\t1", "Not found\t1", "Fragment too short\t1"):
        assert line in rep


# ---- tests/test_reads_processing.py: demultiplex and trimmer --------------

def test_barcode_demultiplex_equal_jax(tmp_path):
    lane = tmp_path / "lane.fastq"
    _fastq(lane, [("a", "ACGT" + "A" * 50), ("b", "ACGTTT" + "C" * 50),
                  ("c", "GGGG" + "T" * 50), ("d", "TTTT" + "G" * 50)])

    def run(P, d):
        bm = P["dx"].BarcodeMap({"ACGT": "s1", "ACGTTT": "s2", "GGGG": "s3"})
        dm = P["dx"].ReadsDemultiplex(bm, min_read_length=10)
        paths = dm.demultiplex_file(str(lane), str(d / "out"), gzip_out=False)
        return dm.stats.assigned, {s: os.path.basename(p) for s, p in paths.items()}

    (assigned, paths), d = _in_both(tmp_path, run)
    assert assigned == 3 and set(paths) == {"s1", "s2", "s3"}
    assert next(iter(tfq.FastqFileReader(str(d / paths["s2"])))).sequence == "C" * 50


@pytest.mark.parametrize("case", ["quality_and_adapter", "degenerate_adapter"])
def test_trimmer_equal_jax(case, tmp_path):
    """test_reads_processing.py::test_trimmer_quality_and_adapter and
    test_degenerate.py::test_trimmer_degenerate_adapter, read by read and
    through RawReadsTrimmer.run's FASTQ."""
    if case == "quality_and_adapter":
        kw = dict(min_quality=20, min_read_length=10, adapters=["AGATCG"])
        reads = [("x", "ACGTACGTACGTACGT" + "AAAA", "I" * 16 + "!!!!"),
                 ("y", "ACGTACGTACGT" + "AGATCG" + "ACGT", "I" * 22),
                 ("z", "ACGT", "!!!!")]
        want = ["ACGTACGTACGTACGT", "ACGTACGTACGT", None]
    else:
        kw = dict(min_quality=0, min_read_length=4, adapters=["AGNTC"])
        reads = [("r1", "ACGTACGTAGCTCGGG", "I" * 16)]
        want = ["ACGTACGT"]
    inp = tmp_path / "in.fastq"
    with open(inp, "w") as fh:
        for n, s, q in reads:
            fh.write(f"@{n}\n{s}\n+\n{q}\n")

    def run(P, d):
        tr = P["trim"].RawReadsTrimmer(**kw)
        out = [tr.trim_read(P["seq"].RawRead(n, s, q)) for n, s, q in reads]
        tr.run(str(inp), str(d / "trimmed.fastq"))
        return [None if r is None else (r.name, r.sequence, r.qualities) for r in out]

    got, _ = _in_both(tmp_path, run)
    assert [None if r is None else r[1] for r in got] == want


# ---- tests/test_degenerate.py ---------------------------------------------

def _degenerate_case(case, P):
    D = P["deg"]
    if case == "extended_bases":
        return [D.get_extended_bases(c) for c in "ANRYMKSWBDHVZ"]
    if case == "degenerate_base_merge":
        return [D.get_degenerate_base(a, b) for a in "ACGT" for b in "ACGT"]
    if case == "complement":
        return [D.degenerate_complement(c) for c in D.DEGENERATE_ALPHABET]
    if case == "reverse_complement":
        return [D.degenerate_reverse_complement(s) for s in ("ARN", "ACGTNRYSWKMBDHV")]
    if case == "mask_roundtrip_and_regex":
        masks = D.encode_degenerate_masks("ACGTNRYSWKMBDHV")
        return (masks.tolist(), D.decode_degenerate_masks(masks),
                [D.make_regular_expression(s) for s in ("ANR", "AGNTC", "BDHV")])
    if case == "match_positions":
        read = D.encode_degenerate_masks("TTACGTTAGGTT")
        return [D.match_positions(D.encode_degenerate_masks(p), read).tolist()
                for p in ("TAR", "NN", "TTACGTTAGGTTA", "W")]
    if case == "aminoacid_codes":
        codes = D.encode_aminoacids("MKV*acdXZ")
        return D.AMINOACIDS, codes.tolist(), D.decode_aminoacids(codes)
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "extended_bases", "degenerate_base_merge", "complement", "reverse_complement",
    "mask_roundtrip_and_regex", "match_positions", "aminoacid_codes",
])
def test_degenerate_equal_jax(case):
    got = _degenerate_case(case, T)
    assert got == _degenerate_case(case, J)
    if case == "extended_bases":
        assert got[:4] == ["A", "ACGT", "AG", "CT"] and got[-1] is None
    elif case == "degenerate_base_merge":
        assert got[2] == "R" and got[7] == "Y" and got[1] == "M" and got[11] == "K"
    elif case == "complement":
        comp = dict(zip(tdeg.DEGENERATE_ALPHABET, got))
        assert comp["A"] == "T" and comp["R"] == "Y" and comp["W"] == "W"
        assert comp["B"] == "V" and all(comp[comp[c]] == c for c in comp)
    elif case == "reverse_complement":
        assert got[0] == "NYT"
    elif case == "mask_roundtrip_and_regex":
        assert got[1] == "ACGTNRYSWKMBDHV" and got[2][0] == "A[ACGT][AG]"
    elif case == "match_positions":
        assert got[0] == [6]
    else:
        assert len(got[0]) == 26 and got[2][:3] == "MKV" and got[2][3] == "X"
