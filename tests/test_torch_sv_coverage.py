"""ngsepcore_tpu_torch's read-pair SV caller, coverage and base-pair
quality statistics and Distribution against the JAX package's, on the
inputs of tests/test_read_pair_sv.py and tests/test_coverage.py: calls
equal field by field, reports equal as text."""
import dataclasses
import io

import numpy as np
import pytest

import ngsepcore_tpu.call.coverage as jcov
import ngsepcore_tpu.call.read_pair_sv as jsv
import ngsepcore_tpu_torch.call.coverage as tcov
import ngsepcore_tpu_torch.call.read_pair_sv as tsv
from ngsepcore_tpu.align.read_alignment import (
    FLAG_FIRST_OF_PAIR,
    FLAG_MATE_REVERSE,
    FLAG_PAIRED,
    FLAG_PROPER,
)
from ngsepcore_tpu.align.read_alignment import ReadAlignment as JAln
from ngsepcore_tpu.core.genome import ReferenceGenome as JGenome
from ngsepcore_tpu.core.sequences import QualifiedSequence as JQS
from ngsepcore_tpu.core.sequences import QualifiedSequenceList as JQSL
from ngsepcore_tpu.core.sequences import decode_dna
from ngsepcore_tpu.math.distribution import Distribution as JDistribution
from ngsepcore_tpu_torch.math.distribution import Distribution as TDistribution
from test_torch_multisample import port_alns, port_genome


def _pair(first, insert, proper=True, same_strand=False, seq="chr1"):
    flags1 = FLAG_PAIRED | FLAG_FIRST_OF_PAIR
    if proper:
        flags1 |= FLAG_PROPER
    if not same_strand:
        flags1 |= FLAG_MATE_REVERSE
    return JAln(
        seq, first, [(100, "M")], flags=flags1, read_chars="A" * 100,
        mate_sequence_name=seq, mate_first=first + insert - 100,
        inferred_insert_size=insert,
    )


def _normal_pairs(seed, n=300):
    rng = np.random.default_rng(seed)
    return [_pair(int(p), int(rng.normal(400, 25))) for p in rng.integers(1, 100000, n)]


def _clip_genome():
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 20000).astype(np.int8)
    seqs = JQSL()
    seqs.add(JQS(name="chr1", codes=codes))
    return JGenome(seqs), codes


def _clipped_aln(codes, aln_first, aln_len, rclip_codes=None, lclip_codes=None):
    body = codes[aln_first - 1 : aln_first - 1 + aln_len]
    cigar, parts = [], []
    if lclip_codes is not None:
        cigar.append((len(lclip_codes), "S"))
        parts.append(lclip_codes)
    parts.append(body)
    cigar.append((aln_len, "M"))
    if rclip_codes is not None:
        cigar.append((len(rclip_codes), "S"))
        parts.append(rclip_codes)
    read_codes = np.concatenate(parts)
    a = JAln("chr1", aln_first, cigar, read_chars=decode_dna(read_codes))
    a._read_codes = read_codes
    a.alignment_quality = 90
    return a


def _split_read_alns(codes, del_start0=8000, del_len=300):
    alns = []
    for i in range(5):
        tail = codes[del_start0 + del_len : del_start0 + del_len + 30]
        alns.append(_clipped_aln(codes, del_start0 - 70 + 1 - i, 70 + i, rclip_codes=tail))
    for i in range(3):
        head = codes[del_start0 - 30 : del_start0]
        alns.append(_clipped_aln(codes, del_start0 + del_len + 1 + i, 70, lclip_codes=head))
    return alns


def _sv_case(name):
    """(genome or None, alignments) of one tests/test_read_pair_sv.py case."""
    if name == "deletion":
        extra = [_pair(50000 - 150 - i * 10, 400 + 2000, proper=False) for i in range(8)]
        return None, _normal_pairs(3) + extra
    if name == "inversion":
        extra = [_pair(70000 + i * 13, 400, proper=False, same_strand=True) for i in range(6)]
        return None, _normal_pairs(4) + extra
    if name == "insertion":
        extra = [_pair(30000 + i * 9, 150, proper=False) for i in range(8)]
        return None, _normal_pairs(5) + extra
    if name == "normal_only":
        return None, _normal_pairs(6)
    genome, codes = _clip_genome()
    alns = _split_read_alns(codes)
    if name == "split_and_pairs":
        alns = alns + [_pair(int(p), 400) for p in range(1000, 19000, 150)] + [
            _pair(8000 - 150 - i * 10, 400 + 300, proper=False) for i in range(8)]
    return genome, alns


def _fields(calls):
    return [dataclasses.asdict(c) for c in calls]


def test_insert_stats_equal_jax():
    rng = np.random.default_rng(2)
    alns = [_pair(int(p), int(rng.normal(400, 30))) for p in rng.integers(1, 100000, 200)]
    want = jsv.insert_length_stats(alns)
    got = tsv.insert_length_stats(port_alns(alns))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert abs(got.mean - 400) < 15 and got.std < 60


@pytest.mark.parametrize(
    "name", ["deletion", "inversion", "insertion", "normal_only", "split_reads",
             "split_and_pairs"])
def test_read_pair_calls_equal_jax(name):
    genome, alns = _sv_case(name)
    want = jsv.ReadPairAnalyzer(genome=genome).find_variants(alns)
    got = tsv.ReadPairAnalyzer(
        genome=None if genome is None else port_genome(genome)
    ).find_variants(port_alns(alns))
    assert _fields(got) == _fields(want)
    if name == "deletion":
        d = [s for s in got if s.variant_type == "DEL"][0]
        assert abs(d.first - 50000) < 500 and 1500 < d.length() < 2500
    if name == "inversion":
        assert abs([s for s in got if s.variant_type == "INV"][0].first - 70000) < 600
    if name == "split_reads":
        d = [c for c in got if c.variant_type == "DEL"][0]
        assert abs(d.first - 8001) <= 10 and abs(d.length() - 300) <= 15
        assert d.total_read_depth >= 3
    if name == "normal_only":
        assert got == []


def _coverage_case(name):
    if name == "toy":
        seq = "ACGT" * 100
        alns = [
            JAln("chr1", 1, [(10, "M")], read_chars="ACGTACGTAC"),
            JAln("chr1", 5, [(10, "M")], read_chars="ACGTACGTAC"),
            JAln("chr1", 9, [(8, "M")], read_chars="ACTTACGT"),
        ]
    else:
        rng = np.random.default_rng(31)
        seq = "".join(rng.choice(list("ACGT"), size=5000))
        alns = []
        for i, s in enumerate(rng.integers(1, 4800, size=400)):
            s = int(s)
            read = list(seq[s - 1 : s + 99])
            for k in rng.integers(0, 100, size=2):
                read[k] = "ACGT"[(("ACGT".index(read[k])) + 1) % 4]
            if i % 5 == 0:  # a 3 bp deletion and a 2 bp insertion
                cigar = [(40, "M"), (3, "D"), (20, "M"), (2, "I"), (38, "M")]
                read = read[:40] + list(seq[s + 42 : s + 62]) + ["A", "C"] + list(
                    seq[s + 62 : s + 100])
            elif i % 7 == 0:
                cigar = [(10, "S"), (90, "M")]
                s += 10
            else:
                cigar = [(100, "M")]
            alns.append(JAln("chr1", s, cigar, read_chars="".join(read),
                             qualities="I" * len(read)))
    seqs = JQSL()
    seqs.add(JQS.from_string("chr1", seq))
    return JGenome(seqs), alns


def _report(calc):
    buf = io.StringIO()
    calc.print_report(buf)
    return buf.getvalue()


@pytest.mark.parametrize("name", ["toy", "simulated"])
def test_coverage_stats_equal_jax(name):
    genome, alns = _coverage_case(name)
    want = jcov.CoverageStatisticsCalculator(genome)
    want.process_alignments(alns)
    got = tcov.CoverageStatisticsCalculator(port_genome(genome))
    got.process_alignments(port_alns(alns))
    np.testing.assert_array_equal(
        got.coverage_distribution().counts, want.coverage_distribution().counts)
    assert _report(got) == _report(want) != ""
    if name == "toy":
        # 1-4 and 15-16 once, 5-8 and 11-14 twice, 9-10 three times
        assert got.coverage_distribution().counts[:4].tolist() == [384, 6, 8, 2]


@pytest.mark.parametrize("name", ["toy", "simulated"])
def test_base_pair_quality_stats_equal_jax(name):
    genome, alns = _coverage_case(name)
    want = jcov.BasePairQualityStatisticsCalculator(genome, read_length=120)
    want.process_alignments(alns)
    got = tcov.BasePairQualityStatisticsCalculator(port_genome(genome), read_length=120)
    got.process_alignments(port_alns(alns))
    np.testing.assert_array_equal(got.totals, want.totals)
    np.testing.assert_array_equal(got.mismatches, want.mismatches)
    assert got.mismatches.sum() > 0
    assert _report(got) == _report(want)


def test_distribution_equals_jax():
    rng = np.random.default_rng(7)
    values = rng.normal(50, 20, size=2000)
    want, got = JDistribution(0, 100, 5), TDistribution(0, 100, 5)
    for d in (want, got):
        for v in values[:10]:
            d.process_datapoint(float(v))
        d.process_array(values[10:])
    np.testing.assert_array_equal(got.counts, want.counts)
    for attr in ("average", "variance", "std_dev", "count", "outliers_less",
                 "outliers_more", "max_value_data", "min_value_data"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.local_mode(20, 80) == want.local_mode(20, 80)
    bw, bg = io.StringIO(), io.StringIO()
    want.print_distribution(bw)
    got.print_distribution(bg)
    assert bg.getvalue() == bw.getvalue() != ""
