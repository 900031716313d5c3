"""ngsepcore_tpu_torch's read-depth CNV callers against the JAX package's
on the CPU, on the inputs of tests/test_read_depth.py (smaller genomes):
bins equal, calls equal field by field for all four algorithms and
cnv_seq_compare, and SingleSampleVariantsDetector.find_cnv_calls."""
import dataclasses

import numpy as np
import pytest
import torch

import ngsepcore_tpu.call.read_depth as jrd
import ngsepcore_tpu_torch.call.read_depth as trd
from ngsepcore_tpu.align.read_alignment import ReadAlignment as JAln
from ngsepcore_tpu.call.single_sample import SingleSampleVariantsDetector as JDetector
from ngsepcore_tpu.core.genome import ReferenceGenome as JGenome
from ngsepcore_tpu.core.sequences import QualifiedSequence as JQS
from ngsepcore_tpu.core.sequences import QualifiedSequenceList as JQSL
from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector as TDetector
from test_torch_multisample import port_alns, port_genome

torch.set_num_threads(1)

ALGORITHMS = ["CNVnator", "EWT", "PoissonHMM", "MAXIMUMLIKELIHOOD"]


def _genome(L, seed=1):
    rng = np.random.default_rng(seed)
    seqs = JQSL()
    seqs.add(JQS.from_string("chr1", "".join(rng.choice(list("ACGT"), size=L))))
    seqs.add(JQS.from_string("chr2", "".join(rng.choice(list("ACGT"), size=L // 3))))
    return JGenome(seqs)


def _alns_with_cnv(L, depth=20, dup_region=(12000, 16000), dup_factor=2, seed=2):
    """tests/test_read_depth.py's workload: uniform coverage `depth` on
    chr1, a segment at dup_factor x, and a thin flat chr2."""
    rng = np.random.default_rng(seed)
    mk = lambda name, s: JAln(name, int(s), [(100, "M")], read_chars="A" * 100)
    alns = [mk("chr1", s) for s in rng.integers(1, L - 100, size=L * depth // 100)]
    a, b = dup_region
    n_extra = (b - a) * depth * (dup_factor - 1) // 100
    alns += [mk("chr1", s) for s in rng.integers(a, b - 100, size=n_extra)]
    alns += [mk("chr2", s) for s in rng.integers(1, L // 3 - 100, size=L // 3 * depth // 100)]
    return alns


def _fitted(module, genome, alns):
    dist = module.ReadDepthDistribution(genome)
    dist.process_alignments(alns)
    dist.correct_depth_by_gc_content()
    dist.fit()
    return dist


def _dist_with_event(module, genome, depth_mean=30.0, del_span=(200, 260),
                     dup_span=(500, 580)):
    """tests/test_read_depth.py::_dist_with_event: a flat synthetic depth
    with one deletion and one duplication."""
    rng = np.random.default_rng(11)
    dist = module.ReadDepthDistribution(genome)
    nbins = len(dist.bins_per_seq[0])
    depth = rng.poisson(depth_mean, size=nbins).astype(float)
    depth[del_span[0]:del_span[1]] = rng.poisson(depth_mean / 2, size=del_span[1] - del_span[0])
    depth[dup_span[0]:dup_span[1]] = rng.poisson(2 * depth_mean, size=dup_span[1] - dup_span[0])
    dist.bins_per_seq[0] = depth
    dist.fit()
    return dist


def _synthetic_genome():
    rng = np.random.default_rng(11)
    seqs = JQSL()
    seqs.add(JQS(name="chr1", codes=rng.integers(0, 4, size=100_000).astype(np.int8)))
    return JGenome(seqs)


def _multi_sequence_genome():
    """Four sequences: 100,000 and 40,000 bp, each with one planted event in
    _multi_sequence_dist; 100 bp (one bin: skipped); 20,000 bp at zero depth
    (skipped)."""
    rng = np.random.default_rng(13)
    seqs = JQSL()
    for name, L in (("chrA", 100_000), ("chrB", 40_000), ("chrC", 100), ("chrD", 20_000)):
        seqs.add(JQS(name=name, codes=rng.integers(0, 4, size=L).astype(np.int8)))
    return JGenome(seqs)


def _multi_sequence_dist(module, genome):
    """Depth 30 with a duplication on chrA (bins 300-380) and a deletion on
    chrB (bins 100-160); chrC's one bin at 31, chrD at zero."""
    rng = np.random.default_rng(17)
    dist = module.ReadDepthDistribution(genome)
    a = rng.poisson(30.0, size=1000).astype(float)
    a[300:380] = rng.poisson(60.0, size=80)
    b = rng.poisson(30.0, size=400).astype(float)
    b[100:160] = rng.poisson(15.0, size=60)
    dist.bins_per_seq[:] = [a, b, np.array([31.0]), np.zeros(200)]
    dist.fit()
    return dist


def _fields(calls):
    return [dataclasses.asdict(c) for c in calls]


def _make(module, name):
    cls = module.CNV_ALGORITHMS[name]
    if module is trd and issubclass(cls, trd.PoissonHMMReadDepthAlgorithm):
        return cls(device="cpu")
    return cls()


@pytest.fixture(scope="module")
def aligned_case():
    L = 30000
    genome = _genome(L)
    alns = _alns_with_cnv(L)
    return (genome, alns, _fitted(jrd, genome, alns),
            _fitted(trd, port_genome(genome), port_alns(alns)))


def test_bins_gc_and_fit_equal_jax(aligned_case):
    _, _, jd, td = aligned_case
    for a, b in zip(jd.bins_per_seq, td.bins_per_seq):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jd.gc_per_seq, td.gc_per_seq):
        np.testing.assert_array_equal(b, a)
    assert td.mean_read_depth == jd.mean_read_depth > 0
    assert td.sigma_read_depth == jd.sigma_read_depth


@pytest.mark.parametrize("name", ALGORITHMS)
def test_calls_equal_jax_on_aligned_reads(aligned_case, name):
    _, _, jd, td = aligned_case
    want = _make(jrd, name).call_cnvs(jd)
    got = _make(trd, name).call_cnvs(td)
    assert _fields(got) == _fields(want)
    if name == "PoissonHMM":
        best = max((c for c in got if c.copy_number > 2), key=lambda c: c.length())
        assert best.copy_number == 4
        assert abs(best.first - 12000) < 2000 and abs(best.last - 16000) < 2000


@pytest.mark.parametrize("name", ALGORITHMS)
def test_calls_equal_jax_on_synthetic_depth(name):
    genome = _synthetic_genome()
    want = _make(jrd, name).call_cnvs(_dist_with_event(jrd, genome))
    got = _make(trd, name).call_cnvs(_dist_with_event(trd, port_genome(genome)))
    assert _fields(got) == _fields(want)
    dels = [c for c in got if c.copy_number < 2]
    dups = [c for c in got if c.copy_number > 2]
    assert any(abs(c.first - 20001) <= 500 for c in dels)
    assert any(abs(c.first - 50001) <= 500 for c in dups)


@pytest.mark.parametrize("name", ["PoissonHMM", "MAXIMUMLIKELIHOOD"])
def test_multi_sequence_calls_equal_jax_in_one_decode(name, monkeypatch):
    """Every sequence of a call is decoded in one viterbi_log_batch call
    (the skipped ones left out) and its path sliced back: calls equal the
    JAX package's, which decodes one sequence at a time."""
    genome = _multi_sequence_genome()
    want = _make(jrd, name).call_cnvs(_multi_sequence_dist(jrd, genome))
    batches = []
    real = trd.viterbi_log_batch

    def counting(start, trans, emits, lengths):
        batches.append(list(lengths))
        return real(start, trans, emits, lengths)

    monkeypatch.setattr(trd, "viterbi_log_batch", counting)
    got = _make(trd, name).call_cnvs(_multi_sequence_dist(trd, port_genome(genome)))
    assert _fields(got) == _fields(want)
    assert batches == [[1000, 400]]
    assert any(c.sequence_name == "chrA" and c.copy_number > 2
               and abs(c.first - 30001) <= 500 for c in got)
    assert any(c.sequence_name == "chrB" and c.copy_number < 2
               and abs(c.first - 10001) <= 500 for c in got)
    assert all(c.sequence_name in ("chrA", "chrB") for c in got)


def test_algorithm_registry_equals_jax():
    assert list(trd.CNV_ALGORITHMS) == list(jrd.CNV_ALGORITHMS)
    for name in ALGORITHMS:
        assert trd.CNV_ALGORITHMS[name].__name__ == jrd.CNV_ALGORITHMS[name].__name__


def test_empty_distribution_gives_no_calls():
    genome = port_genome(_synthetic_genome())
    dist = trd.ReadDepthDistribution(genome)
    dist.fit()
    for name in ALGORITHMS:
        assert _make(trd, name).call_cnvs(dist) == []


@pytest.mark.parametrize("min_ratio,bin_size", [(2.0, 100), (1.5, 200)])
def test_cnv_seq_compare_equals_jax(min_ratio, bin_size):
    L = 30000
    genome = _genome(L)
    control = _alns_with_cnv(L, dup_factor=1, seed=3)
    case = _alns_with_cnv(L, dup_region=(18000, 22000), dup_factor=3, seed=4)
    want = jrd.cnv_seq_compare(genome, case, control, bin_size=bin_size, min_ratio=min_ratio)
    got = trd.cnv_seq_compare(
        port_genome(genome), port_alns(case), port_alns(control),
        bin_size=bin_size, min_ratio=min_ratio,
    )
    assert _fields(got) == _fields(want)
    best = max(got, key=lambda c: c.length())
    assert best.copy_number > 2 and abs(best.first - 18000) < 3000


@pytest.mark.parametrize("alg", ["CNVnator", "ewt,poissonhmm", ",".join(ALGORITHMS)])
def test_find_cnv_calls_equals_jax(aligned_case, alg):
    genome, alns, _, _ = aligned_case
    want = JDetector(genome, alg_cnv=alg).find_cnv_calls(alns)
    got = TDetector(port_genome(genome), alg_cnv=alg, device="cpu").find_cnv_calls(
        port_alns(alns))
    assert want
    assert _fields(got) == _fields(want)


def test_find_cnv_calls_rejects_unknown_algorithm_and_missing_device(aligned_case):
    genome, alns, _, _ = aligned_case
    tgen = port_genome(genome)
    with pytest.raises(ValueError, match="Unknown CNV algorithm"):
        TDetector(tgen, alg_cnv="nope", device="cpu").find_cnv_calls([])
    with pytest.raises(ValueError, match="device"):
        TDetector(tgen, alg_cnv="PoissonHMM").find_cnv_calls([])
