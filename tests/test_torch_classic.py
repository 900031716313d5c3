"""ngsepcore_tpu_torch's classic two-stage flow (ReadsAligner.align_batch
-> SingleSampleVariantsDetector.find_variants) must give the JAX
package's SAM lines and VCF records on the same inputs (CPU, so the port
runs the plain version of the Gotoh kernel).  SAM lines are compared as
full text (placement, flags, MAPQ, CIGAR, NM, sequence, qualities);
records under tests/test_fused_pipeline.py's `_record_key`."""
import warnings

import numpy as np
import pytest
import torch

from ngsepcore_tpu.align.reads_aligner import ReadsAligner as JAligner
from ngsepcore_tpu.call.fused_pipeline import AlignCallPipeline as JPipeline
from ngsepcore_tpu.call.single_sample import SingleSampleVariantsDetector as JDetector
from ngsepcore_tpu.core.genome import ReferenceGenome as JGenome
from ngsepcore_tpu.core.sequences import QualifiedSequence as JQS
from ngsepcore_tpu.core.sequences import QualifiedSequenceList as JQSL
from ngsepcore_tpu.core.sequences import RawRead as JRawRead
from ngsepcore_tpu.simulation.reads_simulator import SingleReadsSimulator
from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner as TAligner
from ngsepcore_tpu_torch.call.fused_pipeline import AlignCallPipeline as TPipeline
from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector as TDetector
from ngsepcore_tpu_torch.core.genome import ReferenceGenome as TGenome
from ngsepcore_tpu_torch.core.sequences import QualifiedSequence as TQS
from ngsepcore_tpu_torch.core.sequences import QualifiedSequenceList as TQSL
from ngsepcore_tpu_torch.core.sequences import RawRead as TRawRead
from test_fused_pipeline import _record_key, _simulate

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)


def _port_genome(genome):
    seqs = TQSL()
    for s in genome.sequences:
        seqs.add(TQS(name=s.name, codes=np.array(s.codes)))
    return TGenome(seqs)


def _port_reads(reads):
    return [TRawRead(name=r.name, sequence=r.sequence, qualities=r.qualities)
            for r in reads]


def _sam(per_read):
    return ["\t".join(a.to_sam_fields()) for alns in per_read for a in alns]


def _align_all(aligner, reads, batch):
    out = []
    for i in range(0, len(reads), batch):
        out.extend(aligner.align_batch(reads[i : i + batch]))
    return out


@pytest.fixture(scope="module")
def sim_case():
    """tests/test_fused_pipeline.py::_simulate(True) aligned and called by
    both packages in 1024-read batches."""
    genome, reads = _simulate(True)
    tgen = _port_genome(genome)
    treads = _port_reads(reads)
    ja = JAligner(genome)
    ta = TAligner(tgen, device="cpu")
    j_per = _align_all(ja, reads, 1024)
    t_per = _align_all(ta, treads, 1024)
    j_alns = [a for r in j_per for a in r]
    t_alns = [a for r in t_per for a in r]
    jrec = JDetector(genome, sample_id="s1").find_variants(j_alns)
    trec = TDetector(tgen, sample_id="s1", device="cpu").find_variants(t_alns)
    return dict(
        genome=genome, reads=reads, tgen=tgen, treads=treads, ja=ja, ta=ta,
        j_per=j_per, t_per=t_per, jrec=jrec, trec=trec,
    )


def test_align_batch_equals_jax_simulated_workload(sim_case):
    js, ts = _sam(sim_case["j_per"]), _sam(sim_case["t_per"])
    assert len(js) > 4000
    assert ts == js
    ja, ta = sim_case["ja"], sim_case["ta"]
    assert ta.complete_alns == ja.complete_alns > 0  # the tier-3 DP ran
    assert ta.aligned_reads == ja.aligned_reads
    assert ta.few_mismatches_alns == ja.few_mismatches_alns
    assert any("D" in l.split("\t")[5] or "I" in l.split("\t")[5] for l in ts)


def test_find_variants_equals_jax(sim_case):
    jk = [_record_key(r) for r in sim_case["jrec"]]
    tk = [_record_key(r) for r in sim_case["trec"]]
    assert len(jk) > 10
    assert any(len(k[2][0]) != len(k[2][1]) for k in jk)  # indel records
    assert tk == jk


def test_port_classic_equals_port_fused(sim_case):
    tgen = sim_case["tgen"]
    pipe = TPipeline(
        tgen,
        aligner=TAligner(tgen, table=sim_case["ta"].table, device="cpu"),
        detector=TDetector(tgen, sample_id="s1", device="cpu"),
        batch_size=1024,
        device="cpu",
    )
    fused = pipe.run_reads(sim_case["treads"])
    assert [_record_key(r) for r in fused] == [
        _record_key(r) for r in sim_case["trec"]
    ]


def test_not_fusable_fallback_equals_jax(sim_case):
    """min_mq=0 is outside the fused path's 16..60: both pipelines run the
    classic flow, which the port no longer refuses."""
    genome, tgen = sim_case["genome"], sim_case["tgen"]
    jpipe = JPipeline(
        genome, aligner=JAligner(genome, table=sim_case["ja"].table),
        detector=JDetector(genome, sample_id="s1", min_mq=0), batch_size=1024,
    )
    tpipe = TPipeline(
        tgen, aligner=TAligner(tgen, table=sim_case["ta"].table, device="cpu"),
        detector=TDetector(tgen, sample_id="s1", min_mq=0, device="cpu"),
        batch_size=1024, device="cpu",
    )
    assert not tpipe._fusable
    jk = [_record_key(r) for r in jpipe.run_reads(sim_case["reads"])]
    tk = [_record_key(r) for r in tpipe.run_reads(sim_case["treads"])]
    assert len(jk) > 10
    assert tk == jk


@pytest.fixture(scope="module")
def toy_case():
    """tests/test_reads_aligner.py's toy genome and read sets."""
    rng = np.random.default_rng(99)
    seqs = JQSL()
    for i, L in enumerate([30000, 20000]):
        s = "".join(rng.choice(list("ACGT"), size=L))
        seqs.add(JQS.from_string(f"chr{i+1}", s))
    genome = JGenome(seqs)
    tgen = _port_genome(genome)
    return genome, tgen, JAligner(genome), TAligner(tgen, device="cpu")


def _toy_reads(genome, which):
    if which == "perfect":
        return SingleReadsSimulator(
            genome, read_length=120, substitution_error_rate=0.0, seed=3
        ).simulate(60)
    if which == "errors":
        return SingleReadsSimulator(
            genome, read_length=120, substitution_error_rate=0.01, seed=7
        ).simulate(60)
    if which == "deletion":
        window = genome.reference_string("chr1", 5001, 5124)
        seq = window[:60] + window[64:120]
        return [JRawRead("del_read", seq, "I" * len(seq))]
    return [JRawRead("junk", "N" * 100, "I" * 100)]


@pytest.mark.parametrize("which", ["perfect", "errors", "deletion", "unmappable"])
def test_align_batch_equals_jax_reads_aligner_inputs(toy_case, which):
    genome, tgen, ja, ta = toy_case
    reads = _toy_reads(genome, which)
    j_per = ja.align_batch(reads)
    t_per = ta.align_batch(_port_reads(reads))
    assert [len(r) for r in t_per] == [len(r) for r in j_per]
    assert _sam(t_per) == _sam(j_per)
    for jr, tr in zip(j_per, t_per):
        for a, b in zip(jr, tr):
            assert (b.sequence_name, b.first, b.cigar, b.flags,
                    b.alignment_quality, b.num_mismatches) == (
                a.sequence_name, a.first, a.cigar, a.flags,
                a.alignment_quality, a.num_mismatches)
    if which == "deletion":
        assert "D" in t_per[0][0].cigar_string
    if which == "unmappable":
        assert t_per == [[]]


def test_concat_pos_round_trip(toy_case):
    genome, tgen, _, _ = toy_case
    for si, pos in ((0, 1), (0, 30000), (1, 1), (1, 12345)):
        c = tgen.concat_pos(si, pos)
        assert c == genome.concat_pos(si, pos)
        assert tgen.split_concat_pos(c) == genome.split_concat_pos(c) == (si, pos)


def test_indel_update_q0_matches_jax_without_warning():
    """A spanning call with q=0 bases: the port's per-call indel update
    gives the JAX value and takes no log10(0) on the way."""
    from ngsepcore_tpu.call.indels import IndelCountsHelper as JHelper
    from ngsepcore_tpu.call.indels import SpanningCall as JCall
    from ngsepcore_tpu_torch.call.indels import IndelCountsHelper as THelper
    from ngsepcore_tpu_torch.call.indels import SpanningCall as TCall

    alleles = ["ACGT", "ACG", "ACCT"]
    calls = [
        (np.array([0, 1, 2, 3], np.int8), np.array([0, 30, 0, 25], np.int8)),
        (np.array([0, 1, 1, 3], np.int8), np.array([0, 0, 0, 0], np.int8)),
        (np.array([0, 1, 2], np.int8), np.array([0, 12, 40], np.int8)),
    ]
    jh, th = JHelper(alleles), THelper(alleles)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for codes, q in calls:
            jh.update(JCall(codes=codes, qualities=q, negative_strand=False))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with np.errstate(all="raise"):
            for codes, q in calls:
                th.update(TCall(codes=codes, qualities=q, negative_strand=False))
    assert np.isfinite(th.logcond).all()
    np.testing.assert_array_equal(th.logcond, jh.logcond)
    np.testing.assert_array_equal(th.counts, jh.counts)
