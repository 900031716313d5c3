"""The known-STR run, de-novo GBS with the repeat-family MSA, and the imputer
at the sizes users run, against the JAX package.

chip_smoke.py's phase 10 (phase 5's 4.6 Mbp genome and 345,000 reads with
its tandem arrays as the known-STR catalogue, AlignCallPipeline.run_reads at
batch 65,536), phase 23 (KmerPrefixReadsClusteringAlgorithm.run on a 24-plex
ApeKI lane of 10,000 loci, 1.92 M reads; the best-star MSA of each of the 30
repeat families of bench.py's 12 Mbp genome) and phase 19 (GenotypeImputer
at k 8, window 5,000, overlap 50, 10 iterations on 300 samples x 20,000
SNVs, held on its first window: a run on the first 5,000 sites gives the
full run's columns [0, 4950), since windows are imputed in order from one
generator and a later window overwrites the overlap) go through each
package on the CPU: the port's plain kernels against JAX under
JAX_PLATFORMS=cpu.  Each side runs in its own process, one after the other
(this file run as a script).  A side builds the inputs with its own classes
and writes every output a user reads as text lines made by its own code;
the test holds the inputs equal, then each output line for line, and the
JAX package's digests to chip_smoke's PHASE10_RECORDS, PHASE23_VCF,
PHASE23_MSA and PHASE19_WINDOW1, which the card's phases are held to.
These cases are marked slow (about 75 minutes in all on 8 cores):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_real_size_more.py -m slow -q -s

The unmarked tests hold the catalogue, the lane's input helper, the MSA
digest and the imputer's first-window property at small sizes.
"""
import dataclasses
import hashlib
import json
import os
import resource
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if path not in sys.path:
        sys.path.insert(0, path)

import chip_smoke  # noqa: E402
from test_torch_bench_workload import _sha  # noqa: E402
from test_torch_paths_workload import _block_digests, _first_difference  # noqa: E402
from test_torch_paths_workload import package as _paths_package  # noqa: E402

SIDE_TIMEOUT_S = 3600
# imputed confidences (the posterior of the chosen genotype), compared in
# log10 as phase 2d compares the forward-backward posteriors
CONF_LOG10_TOL = chip_smoke.FB_POST_TOL
WINDOW, OVERLAP = 5000, 50  # phase 19's


def package(side: str):
    """test_torch_paths_workload.package(side) with the region class, the
    de-novo GBS clustering, the best-star MSA and the imputer."""
    pkg = _paths_package(side)
    if side == "jax":
        from ngsepcore_tpu.clustering.msa import BestStarMultipleSequenceAlignmentAlgorithm
        from ngsepcore_tpu.core.regions import GenomicRegion
        from ngsepcore_tpu.gbs.denovo import KmerPrefixReadsClusteringAlgorithm
        from ngsepcore_tpu.imputation.genotype_imputer import GenotypeImputer
    else:
        from ngsepcore_tpu_torch.clustering.msa import BestStarMultipleSequenceAlignmentAlgorithm
        from ngsepcore_tpu_torch.core.regions import GenomicRegion
        from ngsepcore_tpu_torch.gbs.denovo import KmerPrefixReadsClusteringAlgorithm
        from ngsepcore_tpu_torch.imputation.genotype_imputer import GenotypeImputer
    return types.SimpleNamespace(
        **vars(pkg), GenomicRegion=GenomicRegion, GenotypeImputer=GenotypeImputer,
        KmerPrefixReadsClusteringAlgorithm=KmerPrefixReadsClusteringAlgorithm,
        BestStarMultipleSequenceAlignmentAlgorithm=BestStarMultipleSequenceAlignmentAlgorithm,
    )


# ---------------------------------------------------------------------------
# the runs: each package's own code makes each output's lines


def region_lines(catalogue) -> list:
    return [repr(dataclasses.astuple(r)) for name in sorted(catalogue)
            for r in catalogue[name]]


def run_known_strs(pkg, genome, reads, strs, table) -> dict:
    """Phase 10's run: AlignCallPipeline at batch 65,536 with the catalogue
    on the detector (the pipeline hands it to the aligner)."""
    det = pkg.SingleSampleVariantsDetector(genome, sample_id="s1", **pkg.dev)
    det.known_strs = strs
    pipe = pkg.AlignCallPipeline(
        genome, aligner=pkg.ReadsAligner(genome, table=table, **pkg.dev), detector=det,
        batch_size=65536, **pkg.dev)
    t0 = time.perf_counter()
    records = pipe.run_reads(reads)
    walls = {"run_reads_s": time.perf_counter() - t0}
    lines = {"keys": [repr(chip_smoke.record_key(r)) for r in records],
             "vcf": chip_smoke._vcf_body(records, ["s1"], pkg.VCFFileWriter)}
    return {"lines": lines, "walls": walls,
            "digests": {"keys": chip_smoke.records_digest(records),
                        "vcf": chip_smoke.vcf_body_digest(lines["vcf"])},
            # the port's count of reads aligned by tier 2; the JAX aligner
            # keeps none
            "tier2_reads": getattr(pipe.aligner, "tier2_reads", None)}


def run_gbs(pkg, inp, d) -> dict:
    """Phase 23's clustering: KmerPrefixReadsClusteringAlgorithm.run on the
    lane's FASTQs; the VCF body."""
    t0 = time.perf_counter()
    n = pkg.KmerPrefixReadsClusteringAlgorithm(**pkg.dev).run(
        inp["paths"], inp["ids"], os.path.join(d, "lane"))
    walls = {"run_s": time.perf_counter() - t0}
    body = chip_smoke.vcf_file_body(os.path.join(d, "lane.vcf"))
    assert len(body) == n
    return {"lines": {"vcf": body}, "walls": walls,
            "digests": {"vcf": chip_smoke.vcf_body_digest(body)}}


def run_msa(pkg, families) -> dict:
    """The best-star MSA of each family, in order; rows as msa_digest's
    lines, the wall of each family."""
    rows, walls = [], {}
    for i, fam in enumerate(families):
        t0 = time.perf_counter()
        rows.append(pkg.BestStarMultipleSequenceAlignmentAlgorithm(**pkg.dev)
                    .calculate_multiple_sequence_alignment(fam))
        walls[f"family_{i}_s"] = time.perf_counter() - t0
    walls["all_s"] = sum(walls.values())
    return {"rows": rows, "walls": walls,
            "lines": {"msa": [f"{i}\t{r}" for i, fam in enumerate(rows) for r in fam]},
            "digests": {"msa": chip_smoke.msa_digest(rows)}}


def imputer_inputs(n_samples, n_sites):
    """Phase 19's simulation and mask (_simulate_mosaics, 20% masked)."""
    genotypes, positions, rng = chip_smoke._simulate_mosaics(n_samples, n_sites)
    mask = rng.random(genotypes.shape) < 0.2
    observed = genotypes.copy()
    observed[mask] = -1
    return genotypes, positions, mask, observed


def impute(pkg, observed, positions, **kw):
    return pkg.GenotypeImputer(**kw, **pkg.dev).impute_matrix(observed, positions)


def _log10_diff(a, b) -> float:
    return float(np.abs(np.log10(np.asarray(a, np.float64))
                        - np.log10(np.asarray(b, np.float64))).max())


# ---------------------------------------------------------------------------
# tier 1: the catalogue, the lane's inputs, the MSA digest and the imputer's
# first window, both packages at small size


def _catalogues(arrays):
    return [chip_smoke.str_catalogue("chr1", arrays, package(side).GenomicRegion)
            for side in ("jax", "torch")]


def test_str_catalogue_equal_jax_30kb_with_overlap():
    """The 30 kb genome's arrays plus a pair of overlapping arrays, which
    merge into one region."""
    tandem = chip_smoke.real_size_inputs(0.03, 2, package("jax").classes,
                                         with_reads=False)["tandem"]
    arrays = list(tandem) + [(20_000, 20_060), (20_040, 20_100), (25_000, 25_030)]
    j, t = _catalogues(arrays)
    assert type(j["chr1"][0]).__module__.startswith("ngsepcore_tpu.")
    assert type(t["chr1"][0]).__module__.startswith("ngsepcore_tpu_torch.")
    assert region_lines(t) == region_lines(j)
    assert len(j["chr1"]) == len(arrays) - 1
    assert [(r.first, r.last) for r in j["chr1"] if r.first == 20_001] == [(20_001, 20_100)]


def test_str_catalogue_equal_jax_phase10():
    """Phase 10's catalogue: the tandem arrays of build_repeat_genome at
    4.6 Mbp, 152 regions in both packages."""
    mbp = chip_smoke.GENOME_MBP
    _, _, tandem, _ = chip_smoke.build_repeat_genome(
        np.random.default_rng(2024), int(mbp * 1e6), round(30 * mbp / 12),
        round(400 * mbp / 12))
    j, t = _catalogues(tandem)
    assert region_lines(t) == region_lines(j)
    assert len(j["chr1"]) == 152


SMALL_GBS = dict(bp=100_000, n_loci=50)


@pytest.fixture(scope="module")
def small_gbs(tmp_path_factory):
    """The lane's helper at 50 loci of a 100 kb genome, once a side, and
    each package's VCF body on its own copy."""
    out = {}
    for side in ("jax", "torch"):
        d = str(tmp_path_factory.mktemp(f"gbs_{side}"))
        inp = chip_smoke.gbs_inputs(d, **SMALL_GBS)
        fastq = []
        for p in inp["paths"]:
            with open(p, "rb") as fh:
                fastq.append(fh.read())
        out[side] = dict(inp=inp, fastq=fastq, run=run_gbs(package(side), inp, d))
    return out


def test_gbs_inputs_byte_equal(small_gbs):
    j, t = small_gbs["jax"], small_gbs["torch"]
    assert t["fastq"] == j["fastq"]
    assert len(j["fastq"]) == chip_smoke.GBS_SAMPLES and len(j["inp"]["loci"]) == 50
    reads = sum(b.count(b"\n@r\n") + 1 for b in j["fastq"])
    assert 6 * 50 * chip_smoke.GBS_SAMPLES < reads < 10 * 50 * chip_smoke.GBS_SAMPLES


def test_gbs_vcf_body_equal_jax(small_gbs):
    j, t = small_gbs["jax"]["run"], small_gbs["torch"]["run"]
    assert t["lines"]["vcf"] == j["lines"]["vcf"]
    assert t["digests"] == j["digests"]
    assert j["digests"]["vcf"] == chip_smoke.lines_digest(j["lines"]["vcf"])
    assert len(j["lines"]["vcf"]) >= 10


def test_msa_digest_equal_jax_smallest_families():
    """msa_digest of both packages' rows for the 3 smallest repeat families."""
    fams, order, _ = chip_smoke.msa_families()
    small = [fams[i] for i in order[:3]]
    j, t = (run_msa(package(side), small) for side in ("jax", "torch"))
    assert t["rows"] == j["rows"]
    assert t["digests"] == j["digests"]
    assert j["digests"]["msa"][0] == sum(map(len, small))
    for rows, fam in zip(j["rows"], small):
        assert len({len(r) for r in rows}) == 1 and [r.replace("-", "") for r in rows] == fam


SMALL_IMPUTE = dict(k=8, window_size=300, overlap=10, n_iterations=2, seed=1)


@pytest.fixture(scope="module")
def first_window():
    """Each package's imputation of 40 x 600 sites (windows of 300,
    overlap 10) and of its first 300 sites alone."""
    import torch

    torch.set_num_threads(1)
    _, positions, _, observed = imputer_inputs(40, 600)
    out = {}
    for side in ("jax", "torch"):
        pkg = package(side)
        out[side] = dict(full=impute(pkg, observed, positions, **SMALL_IMPUTE),
                         first=impute(pkg, observed[:, :300], positions[:300], **SMALL_IMPUTE))
    return out


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_imputer_first_window_is_full_runs_columns(first_window, side):
    (full, full_c), (first, first_c) = first_window[side]["full"], first_window[side]["first"]
    cols = 300 - 10
    assert np.array_equal(first[:, :cols], full[:, :cols])
    assert np.array_equal(first_c[:, :cols], full_c[:, :cols])
    # the second window overwrites the overlap
    assert not np.array_equal(first_c[:, cols:], full_c[:, cols:300])


def test_imputer_first_window_equal_jax(first_window):
    (j, jc), (t, tc) = first_window["jax"]["first"], first_window["torch"]["first"]
    assert np.array_equal(t, j) and (j >= 0).all()
    assert _log10_diff(tc, jc) <= CONF_LOG10_TOL
    d_j, d_t = (chip_smoke.imputed_digest(*first_window[s]["first"], 290)
                for s in ("jax", "torch"))
    assert d_t[:2] == d_j[:2]
    assert abs(d_t[2] - d_j[2]) <= chip_smoke.PHASE19_CONF_RTOL * d_j[2]


# ---------------------------------------------------------------------------
# the side runner: one package, one workload, in its own process


def run_side(side: str, workload: str, out_dir: str) -> None:
    """Build `workload`'s inputs with `side`'s package, run it on the CPU
    and write each output's lines to out_dir/<output>.txt and a JSON of the
    input digests, output digests, walls and figures to out_dir/out.json."""
    pkg = package(side)
    t0 = time.perf_counter()
    extra = {}
    if workload == "known_strs":
        inp = chip_smoke.real_size_inputs(chip_smoke.GENOME_MBP, chip_smoke.N_READS,
                                          pkg.classes)
        strs = chip_smoke.str_catalogue("chr1", inp["tandem"], pkg.GenomicRegion)
        inputs = {"codes": _sha(inp["codes"]), "reads": _block_digests(inp["reads"]),
                  "catalogue": chip_smoke.lines_digest(region_lines(strs))}
        t_inputs = time.perf_counter() - t0
        t0 = time.perf_counter()
        table = pkg.MinimizerTable.build_from_genome(inp["genome"], **pkg.dev)
        t_index = time.perf_counter() - t0
        out = run_known_strs(pkg, inp["genome"], inp["reads"], strs, table)
        out["walls"]["index_s"] = t_index
        extra["tier2_reads"] = out.pop("tier2_reads")
    elif workload == "gbs":
        work = os.path.join(out_dir, "work")
        os.makedirs(work, exist_ok=True)
        inp = chip_smoke.gbs_inputs(work)
        inputs = {}
        for p in inp["paths"]:
            with open(p, "rb") as fh:
                inputs[os.path.basename(p)] = hashlib.sha256(fh.read()).hexdigest()
        t_inputs = time.perf_counter() - t0
        out = run_gbs(pkg, inp, work)
        shutil.rmtree(work)
    elif workload == "msa":
        fams = chip_smoke.msa_families()[0]
        inputs = {"families": chip_smoke.lines_digest(
            f"{i}\t{s}" for i, fam in enumerate(fams) for s in fam)}
        t_inputs = time.perf_counter() - t0
        out = run_msa(pkg, fams)
        extra["shapes"] = [[len(f), max(map(len, f))] for f in fams]
        del out["rows"]
    else:
        genotypes, positions, mask, observed = imputer_inputs(chip_smoke.IMPUTE_SAMPLES,
                                                              chip_smoke.IMPUTE_SITES)
        obs, pos = observed[:, :WINDOW], positions[:WINDOW]
        inputs = {"observed": _sha(obs), "positions": _sha(pos)}
        t_inputs = time.perf_counter() - t0
        t0 = time.perf_counter()
        imputed, conf = impute(pkg, obs, pos, k=8, window_size=WINDOW, overlap=OVERLAP,
                               n_iterations=10, seed=1)
        cols = WINDOW - OVERLAP
        np.save(os.path.join(out_dir, "imputed.npy"), imputed)
        np.save(os.path.join(out_dir, "conf.npy"), conf)
        m = mask[:, :cols]
        extra["masked_accuracy"] = float(np.mean(imputed[:, :cols][m] == genotypes[:, :cols][m]))
        out = {"walls": {"impute_s": time.perf_counter() - t0}, "lines": {},
               "digests": {"window1": chip_smoke.imputed_digest(imputed, conf, cols)}}
    out["walls"]["inputs_s"] = t_inputs
    for name, lines in out.pop("lines").items():
        with open(os.path.join(out_dir, name + ".txt"), "w") as fh:
            fh.write("".join(l + "\n" for l in lines))
    out.update(extra, side=side, workload=workload, inputs=inputs,
               max_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
    with open(os.path.join(out_dir, "out.json"), "w") as fh:
        json.dump(out, fh)


# ---------------------------------------------------------------------------
# slow: both packages at real size


def expected(workload: str) -> dict:
    """chip_smoke's constants, by run_side's output names."""
    return {"known_strs": {"keys": chip_smoke.PHASE10_RECORDS},
            "gbs": {"vcf": chip_smoke.PHASE23_VCF},
            "msa": {"msa": chip_smoke.PHASE23_MSA},
            "imputer": {"window1": chip_smoke.PHASE19_WINDOW1}}[workload]


def _side(side, workload, tmp_path):
    out_dir = tmp_path / f"{side}_{workload}"
    out_dir.mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.abspath(__file__), side, workload, str(out_dir)],
                   cwd=ROOT, env=env, check=True, timeout=SIDE_TIMEOUT_S)
    with open(out_dir / "out.json") as fh:
        return json.load(fh), out_dir


@pytest.mark.slow
@pytest.mark.parametrize("workload", ["known_strs", "gbs", "msa", "imputer"])
def test_real_size_outputs_equal_jax(workload, tmp_path):
    (j, jdir), (t, tdir) = (_side(side, workload, tmp_path) for side in ("jax", "torch"))
    for r in (j, t):
        walls = ", ".join(f"{k} {v:.1f}" for k, v in r["walls"].items()
                          if not k.startswith("family_"))
        print(f"[{workload}] {r['side']}: {walls}; max RSS {r['max_rss_gib']:.2f} GiB; "
              f"digests {json.dumps(r['digests'])}")
    assert t["inputs"] == j["inputs"]
    want = expected(workload)
    if workload == "imputer":
        (ji, jc), (ti, tc) = ((np.load(d / "imputed.npy"), np.load(d / "conf.npy"))
                              for d in (jdir, tdir))
        cols = WINDOW - OVERLAP
        diff = np.argwhere(ji[:, :cols] != ti[:, :cols])
        conf_err = _log10_diff(tc[:, :cols], jc[:, :cols])
        print(f"[imputer] masked accuracy {j['masked_accuracy']:.4f} / "
              f"{t['masked_accuracy']:.4f}; dosages differing {len(diff)} "
              f"(sample, site) {diff[:10].tolist()}; max |log10 conf error| {conf_err:.3e}")
        assert len(diff) == 0 and conf_err <= CONF_LOG10_TOL
        (_, jsha, jsum), (_, tsha, tsum) = j["digests"]["window1"], t["digests"]["window1"]
        assert tsha == jsha
        assert abs(tsum - jsum) <= chip_smoke.PHASE19_CONF_RTOL * jsum
        n, sha, conf_sum = want["window1"]
        assert (cols, jsha) == (n, sha)
        assert abs(jsum - conf_sum) <= chip_smoke.PHASE19_CONF_RTOL * conf_sum
        return
    for name in j["digests"]:
        if t["digests"][name] != j["digests"][name]:
            print(f"[{workload}] {name}: first difference (line, JAX, port): "
                  f"{_first_difference(jdir / (name + '.txt'), tdir / (name + '.txt'))}")
    if workload == "known_strs":
        print(f"[known_strs] the port's tier-2 reads {t['tier2_reads']}")
    assert t["digests"] == j["digests"]
    for name in ("keys", "vcf", "msa"):
        if name in j["digests"]:
            assert (jdir / f"{name}.txt").read_text() == (tdir / f"{name}.txt").read_text()
    assert {k: tuple(j["digests"][k]) for k in want} == {k: tuple(v) for k, v in want.items()}


if __name__ == "__main__":
    run_side(*sys.argv[1:4])
