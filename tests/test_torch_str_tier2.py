"""The port's known-STR (tier-2) path must give the JAX package's results on
the same inputs (CPU, so the port runs the plain version of the Gotoh
kernel): per-column ops of the two flank configurations, flank results and
composed alignments of Tier2STRAligner on the tests/test_str_tier2.py
workloads, classic SAM lines and fused records with a known-STR catalogue,
fused records on a slice of a genome with bench.py-style tandem arrays,
and the candidate classifier's STR demotion; a region longer than 1,024
minus the read (the wide Gotoh kernel's case) included.  Everything
compared is an integer or a string, so equality is exact.  A torch model of the CUDA
kernels' free-query-end statements is held against the plain version, since
the kernels themselves run only on the card."""
import numpy as np
import pytest
import torch

from ngsepcore_tpu.align.reads_aligner import ReadsAligner as JAligner
from ngsepcore_tpu.align.str_tier2 import Tier2STRAligner as JTier2
from ngsepcore_tpu.align.str_tier2 import _Tier2Job as JJob
from ngsepcore_tpu.align.str_tier2 import find_tandem_repeat as j_find
from ngsepcore_tpu.call.fused_pipeline import AlignCallPipeline as JPipeline
from ngsepcore_tpu.call.single_sample import SingleSampleVariantsDetector as JDetector
from ngsepcore_tpu.core.regions import GenomicRegion as JRegion
from ngsepcore_tpu.core.sequences import RawRead as JRawRead
from ngsepcore_tpu.core.sequences import decode_dna
from ngsepcore_tpu.kernels import pairwise as jpw
from ngsepcore_tpu.kernels import seeding as jseed
from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner as TAligner
from ngsepcore_tpu_torch.align.reads_aligner import _Candidate as TCandidate
from ngsepcore_tpu_torch.align.str_tier2 import Tier2STRAligner as TTier2
from ngsepcore_tpu_torch.align.str_tier2 import _Tier2Job as TJob
from ngsepcore_tpu_torch.align.str_tier2 import find_tandem_repeat as t_find
from ngsepcore_tpu_torch.call.fused_pipeline import AlignCallPipeline as TPipeline
from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector as TDetector
from ngsepcore_tpu_torch.core.regions import GenomicRegion as TRegion
from ngsepcore_tpu_torch.core.sequences import RawRead as TRawRead
from ngsepcore_tpu_torch.kernels import pairwise as tpw
from ngsepcore_tpu_torch.kernels import seeding as tseed
from ngsepcore_tpu_torch.kernels.pairwise_cuda import (
    NEG,
    gotoh_forward_plane,
    gotoh_forward_plane_ref,
)
from test_fused_pipeline import _record_key
from test_str_tier2 import _str_genome
from test_torch_classic import _align_all, _port_genome, _sam
from test_torch_pairwise import _warp_kernel_model

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

LEFT = dict(free_end1=True, free_start2=True, free_end2=False)
RIGHT = dict(free_start1=True, free_start2=False, free_end2=True)


def _flank_jobs(rng, B, Lq, Ls, side):
    """Flank-like jobs: the query matches one end of the subject and runs
    on as unrelated bases; ragged lengths, a few indels, an empty row."""
    q = np.full((B, Lq), 4, np.int8)
    s = np.full((B, Ls), 4, np.int8)
    ql = rng.integers(Lq // 2, Lq + 1, B).astype(np.int32)
    sl = rng.integers(Ls // 2, Ls + 1, B).astype(np.int32)
    for b in range(B):
        ref = rng.integers(0, 4, sl[b]).astype(np.int8)
        seg = rng.integers(0, 4, ql[b]).astype(np.int8)
        n = int(rng.integers(8, min(ql[b], sl[b]) - 4))
        flank = list(ref[sl[b] - n :] if side == "left" else ref[:n])
        if b % 3 == 0:
            del flank[len(flank) // 2]
        if b % 5 == 0:
            flank.insert(len(flank) // 3, int(rng.integers(0, 4)))
        flank = np.array(flank[: ql[b]], np.int8)
        if side == "left":
            seg[: len(flank)] = flank
        else:
            seg[ql[b] - len(flank) :] = flank
        q[b, : ql[b]] = seg
        s[b, : sl[b]] = ref
    ql[-1] = 0
    sl[-2] = 0
    return q, ql, s, sl


@pytest.mark.parametrize("side,cfg", [("left", LEFT), ("right", RIGHT)])
def test_align_batch_ops_equal_jax(side, cfg):
    rng = np.random.default_rng(5)
    q, ql, s, sl = _flank_jobs(rng, 32, 64, 96, side)
    jres = {k: np.asarray(v) for k, v in
            jpw.affine_gap_align_batch(q, ql, s, sl, **cfg).items()}
    tres = {k: v.numpy() for k, v in tpw.affine_gap_align_batch(
        *(torch.from_numpy(a) for a in (q, ql, s, sl)), **cfg).items()}
    assert set(tres) == set(jres)
    for k in ("score", "end_j", "end_i"):
        assert np.array_equal(tres[k], jres[k]), k
    # An EMPTY query with a free query end ends at row Lq (every row ties at
    # the banned score), and the walk then starts in rows past qlen: the
    # reference's per-cell walk steps through their recomputed pointers,
    # the run-jump walk reads their frozen (zero) run lengths and emits
    # nothing.  Only padding rows are empty in tier 2 and nobody reads
    # their ops (ROADMAP.md Queue 3).
    real = (ql > 0) | (not cfg.get("free_end1", False))
    for k in ("n_ops", "start_j", "ops"):
        assert np.array_equal(tres[k][real], jres[k][real]), k
    if cfg.get("free_end1"):
        assert tres["n_ops"][-1] == 0 and jres["n_ops"][-1] > 0
        assert tres["end_i"][-1] == jres["end_i"][-1] == q.shape[1]
    assert tres["ops"].dtype == np.uint8
    b = 3
    jc = jpw.ops_to_cigar_and_strings(
        jres["ops"][b], int(jres["n_ops"][b]), q[b], s[b], int(jres["start_j"][b]))
    tc = tpw.ops_to_cigar_and_strings(
        tres["ops"][b], int(tres["n_ops"][b]), q[b], s[b], int(tres["start_j"][b]))
    assert tc == jc and len(jc[0]) >= 1


def test_find_tandem_repeat_equals_jax():
    regs = [(10, 20), (40, 45), (46, 80), (200, 210), (300, 301)]
    jr = [JRegion("c", a, b) for a, b in regs]
    tr = [TRegion("c", a, b) for a, b in regs]
    for first, last in [(1, 9), (1, 10), (21, 39), (44, 47), (81, 250), (302, 400), (15, 300)]:
        j, t = j_find(jr, first, last), t_find(tr, first, last)
        assert (j is None) == (t is None)
        if j is not None:
            assert (j.first, j.last) == (t.first, t.last)


def _tier2_reads(codes, region):
    """tests/test_str_tier2.py's three reads: expansion and contraction by
    two units, and a read that ends inside the repeat."""
    motif_len = 4
    unit = codes[region.first - 1 : region.first - 1 + motif_len]
    out = []
    for delta in (2, -2):
        span = np.tile(unit, (region.last - region.first + 1) // motif_len + delta)
        ind = np.concatenate([codes[: region.first - 1], span, codes[region.last :]])
        start = region.first - 1 - 60
        out.append(ind[start : start + 60 + len(span) + 60])
    start = region.first - 1 - 80
    out.append(codes[start : start + 120])
    return out


def test_tier2_alignments_equal_jax():
    """Flank results and composed alignments of the split aligner, and the
    whole ReadsAligner.align_batch with known_strs, on the expansion,
    contraction and ends-inside-the-repeat reads."""
    genome, region, codes = _str_genome()
    tgen = _port_genome(genome)
    tregion = TRegion("chr1", region.first, region.last)
    reads = _tier2_reads(codes, region)
    firsts = [region.first - 60, region.first - 60, region.first - 80]
    jt = JTier2(genome, {"chr1": [region]})
    tt = TTier2(tgen, {"chr1": [tregion]}, device="cpu")
    jjobs, tjobs = [], []
    for rc, first in zip(reads, firsts):
        jjobs.append(JJob(JCand(), rc, first, region, 0))
        tjobs.append(TJob(TCandidate(0, False, 0, 0), rc, first, tregion, 0))
    jt.align_batch(jjobs)
    tt.align_batch(tjobs)
    for jj, tj in zip(jjobs, tjobs):
        assert jj.cand.aln is not None and tj.cand.aln is not None
        assert tj.cand.aln.cigar == jj.cand.aln.cigar
        assert tj.cand.aln.first == jj.cand.aln.first
        assert tj.cand.aln.num_mismatches == jj.cand.aln.num_mismatches
        assert tj.cand.quality == jj.cand.quality
        assert (tj.end_read_segment, tj.start_read_segment, tj.left_ref_start) == (
            jj.end_read_segment, jj.start_read_segment, jj.left_ref_start)
    assert any(op == "I" and ln == 8 for ln, op in tjobs[0].cand.aln.cigar)
    assert any(op == "D" and ln == 8 for ln, op in tjobs[1].cand.aln.cigar)
    assert tjobs[2].cand.aln.cigar[-1][1] == "S"

    jreads = [JRawRead(name=f"r{i}", sequence=decode_dna(rc), qualities="F" * len(rc))
              for i, rc in enumerate(reads)]
    treads = [TRawRead(name=r.name, sequence=r.sequence, qualities=r.qualities)
              for r in jreads]
    ja = JAligner(genome, known_strs={"chr1": [region]})
    ta = TAligner(tgen, known_strs={"chr1": [tregion]}, device="cpu")
    js, ts = _sam(ja.align_batch(jreads)), _sam(ta.align_batch(treads))
    assert len(js) == 3 and ts == js
    assert ta.tier2_reads == 3


class JCand:
    """The fields of a candidate that Tier2STRAligner._compose writes."""
    aln = None
    quality = 0


def test_flank_results_equal_jax():
    """_run_flank's per-job tuples (cigar, mismatches, clip, ok, start_j)
    on both sides, more than one DP_ROWS chunk."""
    genome, region, codes = _str_genome()
    tgen = _port_genome(genome)
    rng = np.random.default_rng(8)
    jt = JTier2(genome, {"chr1": [region]})
    tt = TTier2(tgen, {"chr1": [TRegion("chr1", region.first, region.last)]},
                device="cpu")
    jt.DP_ROWS = tt.DP_ROWS = 8
    for side in ("left", "right"):
        jobs = []
        for i in range(11):
            n = int(rng.integers(30, 70))
            if side == "left":
                ref = codes[region.first - 1 - n - 20 : region.first - 1]
                rd = np.concatenate([ref[-n:], codes[region.first - 1 : region.first + 29]])
            else:
                ref = codes[region.last : region.last + n + 20]
                rd = np.concatenate([codes[region.last - 30 : region.last], ref[:n]])
            rd = rd.copy()
            if i % 4 == 1:
                rd[len(rd) // 2] = (rd[len(rd) // 2] + 1) % 4
            jobs.append((None, rd, ref))
        assert tt._run_flank(jobs, side) == jt._run_flank(jobs, side)


@pytest.fixture(scope="module")
def str_case():
    """The workload of tests/test_fused_pipeline.py::
    test_fused_equals_classic_with_known_strs: two tandem arrays, the first
    expanded by two units in the individual, 3,300 reads of 100 bp."""
    from ngsepcore_tpu.core.genome import ReferenceGenome
    from ngsepcore_tpu.core.sequences import QualifiedSequence, QualifiedSequenceList

    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, size=40000).astype(np.int8)
    unit1 = np.array([0, 1, 3, 3], np.int8)
    codes[15000 : 15000 + 48] = np.tile(unit1, 12)
    codes[30000 : 30000 + 30] = np.tile(np.array([2, 0, 1], np.int8), 10)
    seqs = QualifiedSequenceList()
    seqs.add(QualifiedSequence(name="chr1", codes=codes))
    genome = ReferenceGenome(seqs)
    regs = [(15001, 15048), (30001, 30030)]
    ind = np.concatenate([codes[:15000], np.tile(unit1, 14), codes[15048:]])
    rr = np.random.default_rng(5)
    starts = [int(rr.integers(0, len(ind) - 100)) for _ in range(3000)]
    starts += [int(rr.integers(14880, 15010)) for _ in range(300)]
    reads = []
    for i, start in enumerate(starts):
        rc = ind[start : start + 100]
        if rr.random() < 0.5:
            rc = np.where(rc[::-1] < 4, 3 - rc[::-1], rc[::-1]).astype(np.int8)
        reads.append(JRawRead(name=f"r_{i}", sequence=decode_dna(rc), qualities="F" * 100))
    tgen = _port_genome(genome)
    return dict(
        genome=genome, tgen=tgen, reads=reads,
        treads=[TRawRead(name=r.name, sequence=r.sequence, qualities=r.qualities)
                for r in reads],
        jstrs={"chr1": [JRegion("chr1", a, b) for a, b in regs]},
        tstrs={"chr1": [TRegion("chr1", a, b) for a, b in regs]},
    )


def test_classic_sam_lines_with_known_strs_equal_jax(str_case):
    c = str_case
    ja = JAligner(c["genome"], known_strs=c["jstrs"])
    ta = TAligner(c["tgen"], known_strs=c["tstrs"], device="cpu")
    js = _sam(_align_all(ja, c["reads"], 1024))
    ts = _sam(_align_all(ta, c["treads"], 1024))
    assert len(js) > 3000 and ts == js
    assert ta.tier2_reads > 100
    assert any("8I" in l.split("\t")[5] for l in ts)  # the expansion, one indel
    c["ja"], c["ta"] = ja, ta


def test_fused_records_with_known_strs_equal_jax(str_case):
    c = str_case
    jdet = JDetector(c["genome"], sample_id="s1")
    jdet.known_strs = c["jstrs"]
    jpipe = JPipeline(c["genome"], aligner=JAligner(c["genome"]), detector=jdet,
                      batch_size=1024)
    tdet = TDetector(c["tgen"], sample_id="s1")
    tdet.known_strs = c["tstrs"]
    tpipe = TPipeline(c["tgen"], aligner=TAligner(c["tgen"], device="cpu"),
                      detector=tdet, batch_size=1024, device="cpu")
    assert tpipe._fusable and tpipe.aligner.known_strs is c["tstrs"]
    jk = [_record_key(r) for r in jpipe.run_reads(c["reads"])]
    tk = [_record_key(r) for r in tpipe.run_reads(c["treads"])]
    assert tk == jk
    assert any(14950 <= k[1] <= 15050 and max(len(a) for a in k[2]) > 1 for k in tk)
    assert tpipe.aligner.tier2_reads > 100
    # the port's classic flow with the catalogue gives the same records
    tdet_c = TDetector(c["tgen"], sample_id="s1", device="cpu")
    tdet_c.known_strs = c["tstrs"]
    ta = TAligner(c["tgen"], known_strs=c["tstrs"], device="cpu")
    alns = [a for r in _align_all(ta, c["treads"], 1024) for a in r]
    assert [_record_key(r) for r in tdet_c.find_variants(alns)] == tk


def test_cli_detector_with_known_strs_equals_jax(str_case, tmp_path):
    """python -m ngsepcore_tpu_torch SingleSampleVariantsDetector -knownSTRs
    against the JAX CLI on the same SAM file and catalogue: the realigner's
    STR conciliation is reached, and the VCF bodies are equal."""
    from ngsepcore_tpu.__main__ import main as jmain
    from ngsepcore_tpu.io.fasta import save_fasta
    from ngsepcore_tpu.io.fastq import write_fastq
    from ngsepcore_tpu_torch.__main__ import main as tmain

    c = str_case
    g, r, sam = (str(tmp_path / n) for n in ("g.fa", "r.fastq", "t.sam"))
    save_fasta(c["genome"].sequences, g)
    write_fastq(c["reads"], r)
    strs = tmp_path / "strs.txt"
    strs.write_text("".join(f"chr1\t{x.first}\t{x.last}\n" for x in c["jstrs"]["chr1"]))
    tmain(["--device", "cpu", "ReadsAligner", "-r", g, "-o", sam, r])
    jmain(["SingleSampleVariantsDetector", "-r", g, "-i", sam, "-o",
           str(tmp_path / "j"), "-knownSTRs", str(strs)])
    tmain(["--device", "cpu", "SingleSampleVariantsDetector", "-r", g, "-i", sam,
           "-o", str(tmp_path / "t"), "-knownSTRs", str(strs)])
    tmain(["--device", "cpu", "SingleSampleVariantsDetector", "-r", g, "-i", sam,
           "-o", str(tmp_path / "t_plain")])
    body = lambda p: [l for l in open(p) if not l.startswith("#")]
    jv, tv = body(tmp_path / "j.vcf"), body(tmp_path / "t.vcf")
    assert len(jv) >= 1 and tv == jv
    assert any(14950 <= int(l.split("\t")[1]) <= 15050 for l in tv)
    assert tv != body(tmp_path / "t_plain.vcf")  # the catalogue acts


def test_fused_records_repeat_genome_slice_equal_jax():
    """A 100 kb slice of the known-STR run at full width (chip_smoke.py):
    tandem arrays as bench.build_repeat_genome plants them (motifs of 2-6
    bp, 8-40 copies, so 16-240 bp), the arrays as the catalogue, a diploid
    individual at SNV 0.001 / indel 0.0001 whose repeat lengths equal the
    reference's, 150 bp reads at 11x with 0.3% errors.  Flank windows wider
    than 256 columns occur (region length of slop on a 150 bp read)."""
    from ngsepcore_tpu.core.genome import ReferenceGenome
    from ngsepcore_tpu.core.sequences import QualifiedSequence, QualifiedSequenceList
    from ngsepcore_tpu.core.sequences import ReadBlock as JReadBlock
    from ngsepcore_tpu.simulation.individual_simulator import SingleIndividualSimulator
    from ngsepcore_tpu.simulation.reads_simulator import SingleReadsSimulator
    from test_torch_fused_pipeline import _port_reads

    rng = np.random.default_rng(2024)
    L = 100_000
    codes = rng.integers(0, 4, size=L).astype(np.int8)
    regs = []
    for _ in range(12):
        mlen, ncopies = int(rng.integers(2, 7)), int(rng.integers(8, 41))
        dst = int(rng.integers(0, L - mlen * ncopies))
        codes[dst : dst + mlen * ncopies] = np.tile(
            rng.integers(0, 4, size=mlen).astype(np.int8), ncopies)
        regs.append((dst + 1, dst + mlen * ncopies))
    regs.sort()
    assert all(a[1] < b[0] for a, b in zip(regs, regs[1:]))  # disjoint
    assert max(b - a + 1 for a, b in regs) + 150 > 256
    seqs = QualifiedSequenceList()
    seqs.add(QualifiedSequence(name="chr1", codes=codes))
    genome = ReferenceGenome(seqs)
    sim = SingleIndividualSimulator(genome, snv_rate=0.001, indel_rate=0.0001, seed=7)
    sim.simulate()
    blk = JReadBlock.concatenate([
        SingleReadsSimulator(
            hg, read_length=150, substitution_error_rate=0.003, seed=11 + h
        ).simulate_block(3750)
        for h, hg in enumerate(sim.build_haplotype_genomes())
    ])
    jdet = JDetector(genome, sample_id="s1")
    jdet.known_strs = {"chr1": [JRegion("chr1", a, b) for a, b in regs]}
    jpipe = JPipeline(genome, aligner=JAligner(genome), detector=jdet, batch_size=4096)
    tgen = _port_genome(genome)
    tdet = TDetector(tgen, sample_id="s1")
    tdet.known_strs = {"chr1": [TRegion("chr1", a, b) for a, b in regs]}
    tpipe = TPipeline(tgen, aligner=TAligner(tgen, device="cpu"), detector=tdet,
                      batch_size=4096, device="cpu")
    jk = [_record_key(r) for r in jpipe.run_reads(blk)]
    tk = [_record_key(r) for r in tpipe.run_reads(_port_reads(blk))]
    assert len(jk) > 150 and tk == jk
    assert tpipe.aligner.tier2_reads > 200


def test_full_width_false_snv_calls_equal_jax():
    """What lowers the SNV precision of the known-STR run at full width
    (chip_smoke.py phase 10: 0.9915 against 0.9992 without the catalogue):
    28 false calls at two of every three positions of ONE array, (TTG)14 at
    156,480.  Its genome holds the motif's reverse complement twice more,
    (ACA)15 and (AAC)30; with the catalogue, reads out of the long array are
    placed on the short one, reverse strand, soft-clipped down to the
    repeat.  The JAX package does the same: on that run's own genome,
    individual and reads, cut to 10-13 kb around each of the three arrays,
    the records of both packages are equal, those 28 included; without the
    catalogue the port calls none of them."""
    from chip_smoke import build_repeat_genome
    from ngsepcore_tpu.core.genome import ReferenceGenome
    from ngsepcore_tpu.core.sequences import QualifiedSequence, QualifiedSequenceList
    from ngsepcore_tpu.core.sequences import ReadBlock as JReadBlock
    from ngsepcore_tpu.simulation.individual_simulator import SingleIndividualSimulator
    from ngsepcore_tpu.simulation.reads_simulator import (
        SingleReadsSimulator,
        parse_simulated_read_name,
    )
    from test_torch_fused_pipeline import _port_reads

    codes, _, tandem = build_repeat_genome(
        np.random.default_rng(2024), 4_600_000, 12, 153)
    seqs = QualifiedSequenceList()
    seqs.add(QualifiedSequence(name="chr1", codes=codes))
    sim = SingleIndividualSimulator(
        ReferenceGenome(seqs), snv_rate=0.001, indel_rate=0.0001, seed=7)
    sim.simulate()
    blk = JReadBlock.concatenate([
        SingleReadsSimulator(
            hg, read_length=150, substitution_error_rate=0.003, seed=11 + h
        ).simulate_block(172_500)
        for h, hg in enumerate(sim.build_haplotype_genomes())
    ])
    wins = [(150_000, 163_000), (806_000, 816_000), (3_818_000, 3_829_000)]
    starts = np.array([parse_simulated_read_name(n)[1] for n in blk.names])
    keep = np.zeros(len(starts), bool)
    for lo, hi in wins:
        keep |= (starts > lo + 300) & (starts < hi - 500)
    sel = np.nonzero(keep)[0]
    sub = JReadBlock(blk.codes[sel].copy(), blk.lengths[sel].copy(), None,
                     [blk.names[i] for i in sel], default_quality=blk.default_quality)
    del blk
    seqs = QualifiedSequenceList()
    jstrs, tstrs = {}, {}
    for i, (lo, hi) in enumerate(wins):
        name = f"w{i}"
        seqs.add(QualifiedSequence(name=name, codes=codes[lo:hi].copy()))
        regs = sorted((a - lo + 1, b - lo) for a, b in tandem if lo < a and b < hi)
        jstrs[name] = [JRegion(name, a, b) for a, b in regs]
        tstrs[name] = [TRegion(name, a, b) for a, b in regs]
    assert (6480, 6521) == (tstrs["w0"][0].first, tstrs["w0"][0].last)
    genome = ReferenceGenome(seqs)
    tgen = _port_genome(genome)
    jdet = JDetector(genome, sample_id="s1")
    jdet.known_strs = jstrs
    jpipe = JPipeline(genome, aligner=JAligner(genome), detector=jdet, batch_size=4096)
    jk = [_record_key(r) for r in jpipe.run_reads(sub)]
    keys = {}
    for with_strs in (True, False):
        tdet = TDetector(tgen, sample_id="s1")
        if with_strs:
            tdet.known_strs = tstrs
        tpipe = TPipeline(tgen, aligner=TAligner(tgen, device="cpu"), detector=tdet,
                          batch_size=4096, device="cpu")
        keys[with_strs] = [_record_key(r) for r in tpipe.run_reads(_port_reads(sub))]
    assert keys[True] == jk
    in_short = lambda ks: [k for k in ks if k[0] == "w0" and 6480 <= k[1] <= 6521]
    assert len(in_short(keys[True])) == 28 and not in_short(keys[False])
    # the individual carries no variant there: every one of them is false
    assert not any(156_480 <= c.first <= 156_521 for c in sim.calls)


def _long_region_case():
    """A 6 kb genome with a 1,000 bp array at 2001-3000 and a short known
    STR at 1001-1040; reads of 100 bp from 1941, 2951 and 981."""
    from ngsepcore_tpu.core.genome import ReferenceGenome
    from ngsepcore_tpu.core.sequences import QualifiedSequence, QualifiedSequenceList

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=6000).astype(np.int8)
    codes[2000:3000] = np.tile(np.array([0, 2, 1, 3], np.int8), 250)
    seqs = QualifiedSequenceList()
    seqs.add(QualifiedSequence(name="chr1", codes=codes))
    genome = ReferenceGenome(seqs)
    short, long_ = (1001, 1040), (2001, 3000)
    jreads = [JRawRead(name=f"r{i}", sequence=decode_dna(codes[st : st + 100]),
                       qualities="F" * 100) for i, st in enumerate((1940, 2950, 980))]
    return dict(
        genome=genome, tgen=_port_genome(genome), jreads=jreads,
        treads=[TRawRead(name=r.name, sequence=r.sequence, qualities=r.qualities)
                for r in jreads],
        jstrs={"chr1": [JRegion("chr1", *short), JRegion("chr1", *long_)]},
        tstrs={"chr1": [TRegion("chr1", *short), TRegion("chr1", *long_)]},
    )


def test_long_region_tier2_equals_jax():
    """A region whose length plus the read's is over 1,024 columns goes
    through tier 2 as in the JAX package (on the card the wide Gotoh
    kernel takes its flanks): the region found is JAX's, and three reads
    over a 1,000 bp array and a short one give JAX's SAM lines through
    ReadsAligner(known_strs=...)."""
    c = _long_region_case()
    jt, tt = JTier2(c["genome"], c["jstrs"]), TTier2(c["tgen"], c["tstrs"], device="cpu")
    for span in ((1941, 2040), (2950, 3049), (981, 1080), (3500, 3599)):
        j, t = jt.region_for(0, *span), tt.region_for(0, *span)
        assert (j is None and t is None) or (t.first, t.last) == (j.first, j.last)
    assert (tt.region_for(0, 1941, 2040).first, tt.region_for(0, 2950, 3049).last) == (2001, 3000)
    ja = JAligner(c["genome"], known_strs=c["jstrs"])
    ta = TAligner(c["tgen"], known_strs=c["tstrs"], device="cpu")
    js, ts = _sam(ja.align_batch(c["jreads"])), _sam(ta.align_batch(c["treads"]))
    assert ts == js and len(js) >= 3
    assert ta.tier2_reads >= 3
    # the read over the long array's left edge is split around it
    assert {l.split("\t")[0]: l.split("\t")[5] for l in ts}["r0"].endswith("S")


def test_tier2_plane_cap_chunks_change_no_output():
    """With a plane cap of one byte every flank chunk halves down to one
    row: the SAM lines stay those of 256-row chunks."""
    c = _long_region_case()
    want = _sam(TAligner(c["tgen"], known_strs=c["tstrs"], device="cpu")
                .align_batch(c["treads"]))
    ta = TAligner(c["tgen"], known_strs=c["tstrs"], device="cpu")
    ta.tier2.PLANE_CAP_BYTES = 1
    assert _sam(ta.align_batch(c["treads"])) == want


def test_classify_candidates_str_demotion_equals_jax():
    """Random candidate matrices through both classifiers with STR
    neighbourhoods: every output lane equal, and the demotion acts."""
    rng = np.random.default_rng(13)
    B, C = 64, 4
    offs = np.array([0, 30000, 50000], np.int64)
    pred = rng.integers(0, 49000, (B, C)).astype(np.int32)
    weight = np.sort(rng.integers(0, 12, (B, C)), axis=1)[:, ::-1].astype(np.int32)
    weight[::2, 1:] = 0  # unique placements
    weight[:, 0] += 3
    pred[weight == 0] = (1 << 30)
    strand = rng.integers(0, 2, (B, C)).astype(np.int32)
    mm = rng.integers(0, 6, (B, C)).astype(np.int32)
    cs = rng.integers(0, 4, (B, C)).astype(np.int32)
    ce = rng.integers(0, 4, (B, C)).astype(np.int32)
    lengths = np.full(B, 100, np.int32)
    iv_lo = np.arange(500, 49000, 2500).astype(np.int64)
    iv_hi = iv_lo + 400
    jres = jseed.classify_candidates(
        pred, weight, strand, mm, cs, ce, lengths, offs.astype(np.int32),
        iv_lo.astype(np.int32), iv_hi.astype(np.int32), np.int32(20), has_strs=True)
    t = torch.from_numpy
    tres = tseed.classify_candidates(
        t(pred), t(weight), t(strand), t(mm), t(cs), t(ce), t(lengths), t(offs),
        20, t(iv_lo), t(iv_hi))
    plain = tseed.classify_candidates(
        t(pred), t(weight), t(strand), t(mm), t(cs), t(ce), t(lengths), t(offs), 20)
    for k in jres:
        assert np.array_equal(np.asarray(jres[k]), tres[k].numpy()), k
    assert 0 < int(tres["fused_count"]) < int(plain["fused_count"])


@pytest.mark.parametrize(
    "cfg", [LEFT, RIGHT, dict(free_start1=True, free_end1=True,
                              free_start2=False, free_end2=False)],
    ids=["left-flank", "right-flank", "both-query-ends"],
)
@pytest.mark.parametrize("B,Lq,Ls", [(24, 32, 40), (12, 40, 70), (6, 8, 1)],
                         ids=["K2", "K3", "Ls1"])
def test_kernel_free_query_end_statements_reproduce_plain(B, Lq, Ls, cfg):
    """The warp kernel's statements for the free query ends (column 0 of
    the I state; the running best M[r][slen] with its initial values and
    its `>=` update), as the torch model of tests/test_torch_pairwise.py
    writes them, against the plain version: full plane, score, end_i,
    end_j, start_k.  Rows with qlen 0 (end_i is Lq when slen > 0) and
    slen 0 (row 0 wins with score 0) included."""
    rng = np.random.default_rng(17 + Ls)
    if Ls > 8:
        q, ql, s, sl = _flank_jobs(rng, B, Lq, Ls, "left" if cfg.get("free_end1") else "right")
    else:
        q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
        s = rng.integers(0, 4, (B, Ls)).astype(np.int8)
        ql = rng.integers(0, Lq + 1, B).astype(np.int32)
        sl = rng.integers(0, Ls + 1, B).astype(np.int32)
    ql[0], sl[0] = Lq, Ls  # full rows
    ql[1] = 0  # no active row
    args = [torch.from_numpy(a) for a in (q, ql, s, sl)]
    plane, score, end_i, end_j, start_k = gotoh_forward_plane_ref(*args, **cfg)
    for a, b in zip(gotoh_forward_plane(*args, **cfg), (plane, score, end_i, end_j, start_k)):
        assert torch.equal(a, b)  # a CPU tensor takes the plain version
    got = _warp_kernel_model(*args, **cfg)
    assert torch.equal(got[0], plane)
    assert torch.equal(got[1], score)
    assert torch.equal(got[2], end_j)
    assert torch.equal(got[3], start_k)
    assert torch.equal(got[4], end_i)
    if cfg.get("free_end1"):
        assert int(end_i[1]) == (Lq if sl[1] > 0 else 0)
        assert int(score[1]) == (NEG if sl[1] > 0 else 0)
    # free_start1 changes the plane against the same run without it
    base = gotoh_forward_plane_ref(*args, **dict(cfg, free_start1=False))
    if cfg.get("free_start1") and Ls > 8:
        assert not torch.equal(base[0], plane)
