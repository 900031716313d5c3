"""The port's GLM association test, DBSCAN, best-star MSA and SV GFF reader
against the JAX package on the CPU (ROADMAP.md item 17g).

test_long_tail.py's glm, dbscan and msa cases run through both packages.
MSA rows and DBSCAN clusters are exact; the MSA is also held with its
batches split into row chunks (PLANE_BUDGET_BYTES).  GLM: sample counts
and the kept sites are exact; beta agrees within 1e-10 relative; r2 within
1e-12 absolute and the F statistic within 1e-12 x its degrees of freedom
(r2 = 1 - ss_res / ss_tot is a difference near 1, so its rounding is
absolute, and F = r2 / (1 - r2) x df); the p-value within 1e-8 absolute
(the continued fraction stops once a step changes it by less than 1e-10,
so F values a rounding apart can stop a step apart)."""
import numpy as np
import pytest
import torch

import ngsepcore_tpu.clustering.dbscan as jdb
import ngsepcore_tpu.clustering.msa as jmsa
import ngsepcore_tpu.gwas.glm as jglm
import ngsepcore_tpu.io.gff_sv as jsv
import ngsepcore_tpu.variants.model as jvar
import ngsepcore_tpu.vcf.io as jvcf
import ngsepcore_tpu_torch.clustering.dbscan as tdb
import ngsepcore_tpu_torch.clustering.msa as tmsa
import ngsepcore_tpu_torch.gwas.glm as tglm
import ngsepcore_tpu_torch.io.gff_sv as tsv
import ngsepcore_tpu_torch.variants.model as tvar
import ngsepcore_tpu_torch.vcf.io as tvcf
from chip_smoke import genotype_records

torch.set_num_threads(1)


def assert_glm_close(got, want):
    """The tolerances of this module's docstring."""
    assert [(r["sequence"], r["position"], r["n"]) for r in got] == \
        [(r["sequence"], r["position"], r["n"]) for r in want]
    for key, rtol, atol in (("beta", 1e-10, 0.0), ("r2", 0.0, 1e-12), ("p", 0.0, 1e-8)):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                                   rtol=rtol, atol=atol, err_msg=key)
    df = np.array([r["n"] - 2 for r in want])
    f_got, f_want = np.array([r["f"] for r in got]), np.array([r["f"] for r in want])
    assert (np.abs(f_got - f_want) <= 1e-12 * df).all()


def test_glm_association():
    rng = np.random.default_rng(11)
    n = 60
    samples = [f"s{i}" for i in range(n)]
    causal = rng.integers(0, 3, size=n)
    neutral = rng.integers(0, 3, size=n)
    pheno = {s: float(2.5 * causal[i] + rng.normal(0, 0.5)) for i, s in enumerate(samples)}
    res = {}
    for tag, (var, vcf, glm, kw) in {"j": (jvar, jvcf, jglm, {}),
                                     "t": (tvar, tvcf, tglm, {"device": "cpu"})}.items():
        recs = genotype_records(var, vcf, [causal, neutral], samples)
        res[tag] = glm.GeneralLinearModel(**kw).run_association(recs, pheno)
    assert_glm_close(res["t"], res["j"])
    by_pos = {r["position"]: r for r in res["t"]}
    assert by_pos[100]["p"] < 1e-8 and by_pos[200]["p"] > 0.001
    assert by_pos[100]["beta"] > 1.5


@pytest.fixture(scope="module")
def glm_population():
    """120 samples x 600 sites: 10% missing genotypes, 3 samples without a
    phenotype, 3 causal sites, a monomorphic site, a site of 2 genotyped
    samples, a multiallelic and an indel record."""
    rng = np.random.default_rng(12)
    n, m = 120, 600
    samples = [f"s{i}" for i in range(n)]
    dos = rng.integers(0, 3, (m, n))
    dos[rng.random((m, n)) < 0.1] = -1
    dos[5] = 1
    dos[6, 2:] = -1
    y = dos[:3].clip(0).sum(axis=0) * 1.5 + rng.normal(0, 1, n)
    pheno = {s: float(y[i]) for i, s in enumerate(samples) if i not in (3, 50, 77)}
    return samples, dos, pheno


def test_glm_population_equals_jax(glm_population):
    samples, dos, pheno = glm_population
    res = {}
    for tag, (var, vcf, glm, kw) in {"j": (jvar, jvcf, jglm, {}),
                                     "t": (tvar, tvcf, tglm, {"device": "cpu"})}.items():
        recs = genotype_records(var, vcf, dos, samples)
        recs[7].variant.alleles = ["A", "C", "G"]
        recs[8].variant.alleles = ["AT", "A"]
        res[tag] = glm.GeneralLinearModel(**kw).run_association(recs, pheno)
    assert_glm_close(res["t"], res["j"])
    kept = {r["position"] for r in res["t"]}
    assert len(kept) == 600 - 4 and not kept & {600, 700, 800, 900}
    smallest = sorted(res["t"], key=lambda r: r["p"])[:5]
    assert {100, 200, 300} <= {r["position"] for r in smallest}  # the causal sites


def test_dbscan_standalone():
    adjacency = [[1, 2], [0, 2], [0, 1], [4, 5], [3, 5], [3, 4], []]
    for mod in (jdb, tdb):
        alg = mod.DBSCANClusteringAlgorithm()
        clusters = alg.run_dbscan_clustering(list(range(7)), adjacency, min_pts=2)
        assert sorted(map(sorted, clusters)) == [[0, 1, 2], [3, 4, 5]]
        assert alg.noise_points == [6]


def test_dbscan_random_graphs_equal_jax():
    rng = np.random.default_rng(3)
    for trial in range(20):
        n = int(rng.integers(5, 60))
        pts = rng.random((n, 2))
        eps = float(rng.uniform(0.05, 0.3))
        dist = np.linalg.norm(pts[:, None] - pts[None, :], axis=2)
        adjacency = [[int(j) for j in np.flatnonzero((dist[i] < eps) & (np.arange(n) != i))]
                     for i in range(n)]
        idxs = [int(x) for x in rng.permutation(1000)[:n]]
        min_pts = int(rng.integers(1, 5))
        got = []
        for mod in (jdb, tdb):
            alg = mod.DBSCANClusteringAlgorithm()
            got.append((alg.run_dbscan_clustering(idxs, adjacency, min_pts), alg.noise_points))
        assert got[1] == got[0]


def _msa_sets(rng):
    """test_long_tail's four sequences, then families of mutated copies
    (substitutions and indels) of 1-12 sequences and 0-130 bp."""
    sets = [["ACGTACGTAC", "ACGTACGAC", "ACGTTACGTAC", "ACGTACGTAC"], ["ACGT"], [], ["", "ACG"]]
    for _ in range(8):
        src = "".join(rng.choice(list("ACGT"), size=int(rng.integers(20, 130))))
        fam = []
        for _ in range(int(rng.integers(2, 13))):
            s = list(src)
            for _ in range(int(rng.integers(0, 8))):
                p = int(rng.integers(0, len(s)))
                r = rng.random()
                if r < 0.5:
                    s[p] = "ACGT"[int(rng.integers(0, 4))]
                elif r < 0.75:
                    del s[p]
                else:
                    s.insert(p, "ACGT"[int(rng.integers(0, 4))])
            fam.append("".join(s))
        sets.append(fam)
    return sets


@pytest.mark.parametrize("budget", ["one batch", "row chunks"])
def test_best_star_msa_equals_jax(budget, monkeypatch):
    if budget == "row chunks":  # a plane budget of 3 rows of the widest batch
        monkeypatch.setattr(tmsa, "PLANE_BUDGET_BYTES", 3 * 4 * 160 * 160)
    rng = np.random.default_rng(9)
    for seqs in _msa_sets(rng):
        want = jmsa.BestStarMultipleSequenceAlignmentAlgorithm() \
            .calculate_multiple_sequence_alignment(seqs)
        got = tmsa.BestStarMultipleSequenceAlignmentAlgorithm(device="cpu") \
            .calculate_multiple_sequence_alignment(seqs)
        assert got == want
        assert len({len(a) for a in got}) <= 1
        assert [a.replace("-", "") for a in got] == seqs


def test_sv_gff_round_trip_equals_jax(tmp_path):
    svs = []
    for i, (t, cn) in enumerate((("DEL", 0), ("DUP", 4), ("CNV", 3), ("INV", 2))):
        svs.append(tvar.CalledGenomicVariant(
            sequence_name=f"chr{i % 2}", first=1000 * (i + 1), alleles=["N"], variant_type=t,
            quality=30 + i, last_=1000 * (i + 1) + 500, copy_number=cn))
    tsv.write_sv_gff(svs, str(tmp_path / "sv.gff"))
    with open(tmp_path / "sv.gff", "a") as fh:
        fh.write("chr9\tother\tDEL\t5\t50\t.\t.\t.\tID=x\n#comment\nshort\tline\n")
    got = tsv.read_sv_gff(str(tmp_path / "sv.gff"))
    want = jsv.read_sv_gff(str(tmp_path / "sv.gff"))
    fields = lambda c: (c.sequence_name, c.first, c.last, c.alleles, c.variant_type,
                        c.quality, c.copy_number)
    assert [fields(c) for c in got] == [fields(c) for c in want]
    assert [fields(c) for c in got[:4]] == [fields(c) for c in svs]
    assert fields(got[4]) == ("chr9", 5, 50, ["N"], "DEL", 0, 2)
