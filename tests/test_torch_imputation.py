"""ngsepcore_tpu_torch.imputation against ngsepcore_tpu.imputation on the
CPU, on tests/test_imputation.py's two workloads (40 samples x 300 sites,
k 4, one window of 400, 15 iterations; the 10 x 60 VCF round trip, k 4,
window 100, 8 iterations) and on the first with three overlapping
windows.  Imputed dosages are identical; the confidence of each call
within 1e-9 absolute; the final E-step's posteriors and the genotype
probabilities of the final theta within 1e-9 absolute (both are captured
from each package's host einsum); the _imputed.vcf bodies identical, from
GenotypeImputer.run and through each package's CLI."""
import numpy as np
import pytest
import torch

import ngsepcore_tpu.imputation.genotype_imputer as jimp
import ngsepcore_tpu_torch.imputation.genotype_imputer as timp
from ngsepcore_tpu.__main__ import main as jmain
from ngsepcore_tpu_torch.__main__ import main as tmain
from test_imputation import _simulate_population

torch.set_num_threads(1)

TOL = 1e-9  # EM over ~16 E-steps: sums in another order drift by ~1e-13


class _EinsumTap:
    """Stands for numpy in an imputer module: records the operands of each
    np.einsum (the final genotype posterior: posteriors and the genotype
    probabilities of the final theta) and passes everything else on."""

    def __init__(self):
        self.calls = []

    def einsum(self, subscripts, *operands, **kw):
        self.calls.append([np.array(o) for o in operands])
        return np.einsum(subscripts, *operands, **kw)

    def __getattr__(self, name):
        return getattr(np, name)


def _impute(module, monkeypatch, dosages, positions, **kw):
    tap = _EinsumTap()
    with monkeypatch.context() as m:
        m.setattr(module, "np", tap)
        if module is timp:
            kw["device"] = "cpu"
        imputed, conf = module.GenotypeImputer(**kw).impute_matrix(dosages, positions)
    return imputed, conf, tap.calls


WORKLOADS = {
    "one_window": dict(k=4, window_size=400, n_iterations=15, seed=2),
    "three_windows": dict(k=4, window_size=120, overlap=20, n_iterations=4, seed=2),
}


@pytest.fixture(scope="module")
def matrix_runs():
    """Each workload through both packages (the JAX runs once a module)."""
    genotypes, positions = _simulate_population()
    mask = np.random.default_rng(7).random(genotypes.shape) < 0.15
    observed = genotypes.copy()
    observed[mask] = -1
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, kw in WORKLOADS.items():
            out[name] = tuple(_impute(mod, mp, observed, positions, **kw)
                              for mod in (jimp, timp))
    return genotypes, mask, out


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_impute_matrix_equals_jax(matrix_runs, name):
    genotypes, mask, runs = matrix_runs
    (j_imp, j_conf, j_calls), (t_imp, t_conf, t_calls) = runs[name]
    assert t_imp.dtype == j_imp.dtype and t_imp.shape == j_imp.shape
    np.testing.assert_array_equal(t_imp, j_imp)
    np.testing.assert_allclose(t_conf, j_conf, rtol=0, atol=TOL)
    windows = {"one_window": 1, "three_windows": 3}[name]
    assert len(t_calls) == len(j_calls) == windows
    for (t_post, t_pg), (j_post, j_pg) in zip(t_calls, j_calls):
        np.testing.assert_allclose(t_post, j_post, rtol=0, atol=TOL)
        np.testing.assert_allclose(t_pg, j_pg, rtol=0, atol=TOL)
    acc = float(np.mean(t_imp[mask] == genotypes[mask]))
    assert acc > 0.9, f"imputation accuracy {acc}"


def _write_population_vcf(path, genotypes, positions, mask, writer_mod, model_mod):
    """tests/test_imputation.py::test_imputation_vcf_roundtrip's VCF."""
    samples = [f"s{i}" for i in range(genotypes.shape[0])]
    with writer_mod.VCFFileWriter(path, samples) as w:
        for t in range(genotypes.shape[1]):
            calls = []
            for s in range(genotypes.shape[0]):
                g = int(genotypes[s, t])
                idxs = [] if mask[s, t] else ([0, 0] if g == 0 else [0, 1] if g == 1 else [1, 1])
                calls.append(model_mod.CalledGenomicVariant(
                    sequence_name="chr1", first=int(positions[t]), alleles=["A", "C"],
                    sample_id=samples[s], indexes_called_alleles=idxs, genotype_quality=60,
                ))
            w.write(writer_mod.VCFRecord(variant=calls[0], calls=calls))


def _body(path):
    with open(path) as fh:
        return [line for line in fh if not line.startswith("#")]


@pytest.fixture(scope="module")
def vcf_runs(tmp_path_factory):
    import ngsepcore_tpu.variants.model as jmodel
    import ngsepcore_tpu.vcf.io as jio

    d = tmp_path_factory.mktemp("impute")
    genotypes, positions = _simulate_population(n_samples=10, n_sites=60)
    mask = np.random.default_rng(1).random(genotypes.shape) < 0.2
    p = str(d / "pop.vcf")
    _write_population_vcf(p, genotypes, positions, mask, jio, jmodel)
    jimp.GenotypeImputer(k=4, window_size=100, n_iterations=8, seed=5).run(p, str(d / "j"))
    timp.GenotypeImputer(k=4, window_size=100, n_iterations=8, seed=5,
                         device="cpu").run(p, str(d / "t"))
    cli = ["VCFImpute", "-i", p, "-k", "4", "-w", "100", "-t", "8"]
    jmain(cli + ["-o", str(d / "jcli")])
    tmain(["--device", "cpu"] + cli + ["-o", str(d / "tcli")])
    return d, genotypes


def test_vcf_round_trip_equals_jax(vcf_runs):
    d, genotypes = vcf_runs
    want = _body(d / "j_imputed.vcf")
    assert len(want) == genotypes.shape[1]
    assert _body(d / "t_imputed.vcf") == want


def test_cli_vcf_equals_jax(vcf_runs):
    """VCFImpute through both CLIs at the default seed (the JAX CLI has no
    -seed option; the port's defaults to the same 1)."""
    d, _ = vcf_runs
    want = _body(d / "jcli_imputed.vcf")
    assert len(want) == 60
    assert _body(d / "tcli_imputed.vcf") == want
    from ngsepcore_tpu_torch.vcf.io import VCFFileReader

    back = VCFFileReader(str(d / "tcli_imputed.vcf")).load_all()
    assert not any(c.is_undecided for r in back for c in r.calls)


def test_diploid_emissions_equal_jax():
    """The batched emissions against the JAX function vmapped over samples,
    missing dosages included: within 1e-15 absolute (log10 of the same
    products)."""
    import jax

    rng = np.random.default_rng(11)
    theta = np.clip(rng.random((30, 3)), 1e-3, 1 - 1e-3)
    dos = rng.integers(-1, 3, size=(5, 30)).astype(np.int8)
    want = jax.vmap(jimp._diploid_emissions, in_axes=(None, 0))(theta, dos)
    got = timp._diploid_emissions(torch.from_numpy(theta), torch.from_numpy(dos))
    assert got.shape == (5, 30, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-15)
