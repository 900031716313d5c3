"""ngsepcore_tpu_torch's AlignCallPipeline.run_reads must emit the records
of ngsepcore_tpu's fused pipeline on the same inputs (CPU, so the port
runs the plain versions of its two CUDA kernels).  Records are compared
under tests/test_fused_pipeline.py's `_record_key`: sites, alleles,
genotypes, GQ, rounded QUAL, depths and PLs."""
import numpy as np
import torch

from ngsepcore_tpu.align.reads_aligner import ReadsAligner as JAligner
from ngsepcore_tpu.call.fused_pipeline import AlignCallPipeline as JPipeline
from ngsepcore_tpu.call.single_sample import SingleSampleVariantsDetector as JDetector
from ngsepcore_tpu.core.genome import ReferenceGenome as JGenome
from ngsepcore_tpu.core.sequences import QualifiedSequence as JQS
from ngsepcore_tpu.core.sequences import QualifiedSequenceList as JQSL
from ngsepcore_tpu.core.sequences import ReadBlock as JReadBlock
from ngsepcore_tpu.simulation.individual_simulator import SingleIndividualSimulator
from ngsepcore_tpu.simulation.reads_simulator import SingleReadsSimulator
from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner as TAligner
from ngsepcore_tpu_torch.call.fused_pipeline import AlignCallPipeline as TPipeline
from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector as TDetector
from ngsepcore_tpu_torch.core.genome import ReferenceGenome as TGenome
from ngsepcore_tpu_torch.core.sequences import QualifiedSequence as TQS
from ngsepcore_tpu_torch.core.sequences import QualifiedSequenceList as TQSL
from ngsepcore_tpu_torch.core.sequences import RawRead as TRawRead
from ngsepcore_tpu_torch.core.sequences import ReadBlock as TReadBlock
from test_fused_pipeline import _record_key, _simulate

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)


def _port_genome(genome):
    seqs = TQSL()
    for s in genome.sequences:
        seqs.add(TQS(name=s.name, codes=np.array(s.codes)))
    return TGenome(seqs)


def _port_reads(reads):
    if isinstance(reads, JReadBlock):
        return TReadBlock(
            reads.codes.copy(), reads.lengths.copy(),
            None if reads.quals is None else reads.quals.copy(),
            reads.names, default_quality=reads.default_quality,
        )
    return [TRawRead(name=r.name, sequence=r.sequence, qualities=r.qualities)
            for r in reads]


def _both(genome, reads, batch_size):
    jpipe = JPipeline(
        genome,
        aligner=JAligner(genome),
        detector=JDetector(genome, sample_id="s1"),
        batch_size=batch_size,
    )
    jrec = jpipe.run_reads(reads)
    tgen = _port_genome(genome)
    tpipe = TPipeline(
        tgen,
        aligner=TAligner(tgen, device="cpu"),
        detector=TDetector(tgen, sample_id="s1"),
        batch_size=batch_size,
        device="cpu",
    )
    trec = tpipe.run_reads(_port_reads(reads))
    return [_record_key(r) for r in jrec], [_record_key(r) for r in trec], tpipe


def test_port_equals_jax_snv_workload():
    genome, reads = _simulate(False)
    jk, tk, _ = _both(genome, reads, 1024)
    assert len(jk) > 10
    assert tk == jk


def test_port_equals_jax_indel_workload():
    genome, reads = _simulate(True)
    jk, tk, tpipe = _both(genome, reads, 1024)
    assert len(jk) > 10
    assert any(len(k[2][0]) != len(k[2][1]) for k in jk)  # indel records
    assert tk == jk
    assert tpipe.aligner.complete_alns > 0  # the tier-3 DP ran


def test_port_equals_jax_read_block_workload():
    """The ReadBlock workload of tests/test_fused_pipeline.py
    (test_read_block_path_identical): 150 bp reads as dense matrices."""
    rng = np.random.default_rng(3)
    seqs = JQSL()
    seqs.add(JQS(name="chr1", codes=rng.integers(0, 4, size=40_000).astype(np.int8)))
    genome = JGenome(seqs)
    sim = SingleIndividualSimulator(genome, snv_rate=0.002, indel_rate=0.0, seed=9)
    sim.simulate()
    hap = sim.build_haplotype_genomes()
    blk = JReadBlock.concatenate(
        [
            SingleReadsSimulator(
                hg, read_length=150, substitution_error_rate=0.003, seed=50 + h
            ).simulate_block(2500)
            for h, hg in enumerate(hap)
        ]
    )
    jk, tk, _ = _both(genome, blk, 4096)
    assert len(jk) > 20
    assert tk == jk


def test_port_equals_jax_repeat_family_60kb():
    """The 60 kb dispersed-repeat-family workload that
    tests/test_fused_pipeline.py defines first and then shadows under the
    same test name: multi-mapping reads resolved on the device path."""
    rng = np.random.default_rng(77)
    codes = rng.integers(0, 4, size=60000).astype(np.int8)
    seg = codes[5000:6500].copy()
    for dst, div in ((12000, 0.01), (22000, 0.02), (31000, 0.05),
                     (40000, 0.0), (52000, 0.03)):
        cp = seg.copy()
        nm = int(div * len(cp))
        if nm:
            mp = rng.choice(len(cp), size=nm, replace=False)
            cp[mp] = (cp[mp] + rng.integers(1, 4, size=nm)) % 4
        codes[dst : dst + len(cp)] = cp
    seqs = JQSL()
    seqs.add(JQS(name="chrR", codes=codes))
    genome = JGenome(seqs)
    sim = SingleIndividualSimulator(genome, snv_rate=0.002, indel_rate=0.0003, seed=5)
    sim.simulate()
    hap = sim.build_haplotype_genomes()
    reads = []
    for h, hg in enumerate(hap):
        reads.extend(
            SingleReadsSimulator(
                hg, read_length=100, substitution_error_rate=0.004, seed=60 + h,
            ).simulate(3000)
        )
    jk, tk, _ = _both(genome, reads, 1024)
    assert len(jk) > 10
    assert tk == jk
