"""ngsepcore_tpu_torch's single individual haplotyping (haplotyping/sih.py,
a numpy copy) against the JAX package on the CPU: every algorithm's
haplotype and MEC score on tests/test_haplotyping_benchmark.py's fragment
matrices, the max-cut builder, the phased blocks of
SingleIndividualHaplotyper, and the SIH command's VCF.  Integers exact
(tolerance 0).  The gold-standard comparator is not ported yet
(ROADMAP.md Queue 1 item 17)."""
import numpy as np
import pytest

from ngsepcore_tpu.__main__ import main as jmain
from ngsepcore_tpu.align.read_alignment import ReadAlignment as JAln
from ngsepcore_tpu.haplotyping import sih as jsih
from ngsepcore_tpu.variants.model import CalledGenomicVariant as JCall
from ngsepcore_tpu.vcf.io import VCFFileWriter, VCFRecord as JRecord
from ngsepcore_tpu_torch.__main__ import main as tmain
from ngsepcore_tpu_torch.align.read_alignment import ReadAlignment as TAln
from ngsepcore_tpu_torch.haplotyping import sih as tsih
from ngsepcore_tpu_torch.variants.model import CalledGenomicVariant as TCall
from ngsepcore_tpu_torch.vcf.io import VCFRecord as TRecord
from test_haplotyping_benchmark import _simulate_fragments, _simulated_fragments

ALGORITHMS = list(jsih.SIH_ALGORITHMS)


def _clean_matrix():
    """test_all_sih_algorithms_phase_correctly's matrix (2% errors)."""
    rng = np.random.default_rng(9)
    V, F = 20, 60
    truth = rng.integers(0, 2, size=V).astype(np.int8)
    frags = np.full((F, V), -1, np.int8)
    for i in range(F):
        a = rng.integers(0, V - 4)
        b = a + rng.integers(3, 8)
        side = rng.integers(0, 2)
        frags[i, a:min(b, V)] = truth[a:min(b, V)] if side == 0 else 1 - truth[a:min(b, V)]
    noise = rng.random((F, V)) < 0.02
    return np.where((frags >= 0) & noise, 1 - frags, frags)


MATRICES = {
    "refhap-test": lambda: _simulate_fragments(
        np.random.default_rng(42).integers(0, 2, size=40).astype(np.int8), 200, 6, 0.02,
        np.random.default_rng(43)),
    "clean": _clean_matrix,
    "mec-test": lambda: _simulated_fragments()[0],
}


@pytest.mark.parametrize("matrix", list(MATRICES))
@pytest.mark.parametrize("name", ALGORITHMS)
def test_sih_algorithms_equal_jax(name, matrix):
    frags = MATRICES[matrix]()
    jhap, jmec = jsih.SIH_ALGORITHMS[name]().phase(frags.copy())
    thap, tmec = tsih.SIH_ALGORITHMS[name]().phase(frags.copy())
    assert tmec == jmec
    assert np.array_equal(thap, jhap) and thap.dtype == jhap.dtype


def test_refhap_seeded_equals_jax():
    """test_refhap_recovers_haplotype's call: RefhapSIHAlgorithm(seed=3)."""
    rng = np.random.default_rng(42)
    hap = rng.integers(0, 2, size=40).astype(np.int8)
    frags = _simulate_fragments(hap, 200, 6, 0.02, rng)
    jhap, jmec = jsih.RefhapSIHAlgorithm(seed=3).phase(frags)
    thap, tmec = tsih.RefhapSIHAlgorithm(seed=3).phase(frags)
    assert tmec == jmec and np.array_equal(thap, jhap)
    assert max(np.mean(thap == hap), np.mean(thap != hap)) > 0.95


@pytest.mark.parametrize("matrix", ["family", "mec-test"])
def test_fragments_cut_builder_equals_jax(matrix):
    frags = (np.array([[0, 0, 0, 0], [0, 0, 0, -1], [1, 1, 1, 1], [-1, 1, 1, 1]], np.int8)
             if matrix == "family" else _simulated_fragments()[0])
    jb, tb = jsih.FragmentsCutBuilder(frags), tsih.FragmentsCutBuilder(frags)
    assert np.array_equal(tb.W, jb.W)
    assert np.array_equal(tb.calculate_max_cut(), jb.calculate_max_cut())


def _end_to_end(Call, Record, Aln):
    """test_sih_end_to_end_blocks' input in one package's classes: four
    het SNVs at 100..400, 60 reads over pairs of them, plus two more at
    600 and 700 covered by reads of one allele pattern."""
    positions = [100, 200, 300, 400, 600, 700]
    hap = [0, 1, 1, 0, 1, 0]
    records = []
    for p in positions:
        c = Call(sequence_name="chr1", first=p, alleles=["A", "C"],
                 indexes_called_alleles=[0, 1], genotype_quality=60, sample_id="s")
        records.append(Record(variant=c, calls=[c]))
    alns = []
    for i in range(66):
        vi = i % 3 if i < 60 else 4
        side = (i // 3) % 2
        first = positions[vi]
        span = positions[vi + 1] - first + 1
        chars = []
        for p in range(first, first + span):
            if p in positions:
                j = positions.index(p)
                chars.append("AC"[hap[j] if side == 0 else 1 - hap[j]])
            else:
                chars.append("G")
        alns.append(Aln("chr1", first, [(span, "M")], read_chars="".join(chars),
                        read_name=f"f{i}"))
    return records, alns


@pytest.mark.parametrize("name", ALGORITHMS)
def test_haplotyper_blocks_equal_jax(name):
    jrec, jalns = _end_to_end(JCall, JRecord, JAln)
    trec, talns = _end_to_end(TCall, TRecord, TAln)
    jblocks = jsih.SingleIndividualHaplotyper(name).phase(jrec, jalns)
    tblocks = tsih.SingleIndividualHaplotyper(name).phase(trec, talns)
    assert len(jblocks) == 2
    key = lambda bs: [(b.var_indices, b.haplotype.tolist(), b.mec) for b in bs]
    assert key(tblocks) == key(jblocks)
    calls = lambda rs: [(r.calls[0].phased, r.calls[0].indexes_called_alleles) for r in rs]
    assert calls(trec) == calls(jrec)


def test_cli_sih_equals_jax(tmp_path, capsys):
    """SIH -i calls.vcf -b alns.sam -o phased.vcf through both CLIs: the
    same VCF and the same summary of blocks."""
    records, alns = _end_to_end(JCall, JRecord, JAln)
    with VCFFileWriter(str(tmp_path / "calls.vcf"), ["s"]) as w:
        for r in records:
            w.write(r)
    with open(tmp_path / "alns.sam", "w") as fh:
        fh.write("@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:1000\n")
        for a in alns:
            fh.write(f"{a.read_name}\t0\tchr1\t{a.first}\t60\t{a.cigar[0][0]}M\t*\t0\t0\t"
                     f"{a.read_chars}\t*\n")
    summary = {}
    for tag, run, pre in (("j", jmain, []), ("t", tmain, ["--device", "cpu"])):
        capsys.readouterr()
        run(pre + ["SIH", "-i", str(tmp_path / "calls.vcf"), "-b", str(tmp_path / "alns.sam"),
                   "-o", str(tmp_path / f"{tag}.vcf")])
        summary[tag] = [l for l in capsys.readouterr().err.splitlines() if l.startswith("Phased")]
    body = lambda p: open(tmp_path / p).read()
    assert body("t.vcf") == body("j.vcf")
    assert summary["t"] == summary["j"] == ["Phased 6 variants in 2 blocks (MEC 0)"]
