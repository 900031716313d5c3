"""Importing ngsepcore_tpu_torch must not load jax or ngsepcore_tpu (the
machine with the GPU has no jax), nor triton, nor build the CUDA kernels:
those are built at their first CUDA launch.  Checked in a fresh
interpreter so this test process's own imports do not interfere."""
import json
import os
import subprocess
import sys

import pytest

_PROBE = r"""
import importlib, json, pkgutil, sys
import ngsepcore_tpu_torch
names = sorted(
    m.name
    for m in pkgutil.walk_packages(
        ngsepcore_tpu_torch.__path__, "ngsepcore_tpu_torch."
    )
)
for n in names:
    importlib.import_module(n)
from ngsepcore_tpu_torch.kernels import cuda_build
loaded = lambda p: sorted(m for m in sys.modules if m == p or m.startswith(p + "."))
print(json.dumps({
    "modules": names,
    "jax": loaded("jax"),
    "tpu": loaded("ngsepcore_tpu"),
    "triton": loaded("triton"),
    "built": cuda_build._lib is not None,
}))
"""


def test_port_imports_without_jax_triton_or_nvcc():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root
    env["PATH"] = os.path.dirname(sys.executable)  # no nvcc reachable
    env.pop("CUDA_HOME", None)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=root, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in (
        "ngsepcore_tpu_torch.call.fused_pipeline",
        "ngsepcore_tpu_torch.kernels.pairwise_cuda",
        "ngsepcore_tpu_torch.kernels.shear_pileup",
        "ngsepcore_tpu_torch.index.minimizer_table",
        "ngsepcore_tpu_torch.kernels.hmm",
        "ngsepcore_tpu_torch.call.multisample",
        "ngsepcore_tpu_torch.call.read_depth",
        "ngsepcore_tpu_torch.call.read_pair_sv",
        "ngsepcore_tpu_torch.call.coverage",
        "ngsepcore_tpu_torch.math.distribution",
        "ngsepcore_tpu_torch.align.long_reads",
        "ngsepcore_tpu_torch.align.hits_clustering",
        "ngsepcore_tpu_torch.call.long_read_sv",
        "ngsepcore_tpu_torch.graphs.components",
        "ngsepcore_tpu_torch.kernels.minimizers",
        "ngsepcore_tpu_torch.kernels.pairwise",
        "ngsepcore_tpu_torch.kernels.genotyping",
        "ngsepcore_tpu_torch.assembly.assembler",
        "ngsepcore_tpu_torch.assembly.graph",
        "ngsepcore_tpu_torch.assembly.layout",
        "ngsepcore_tpu_torch.assembly.polishing",
        "ngsepcore_tpu_torch.assembly.read_correction",
        "ngsepcore_tpu_torch.assembly.phasing",
        "ngsepcore_tpu_torch.haplotyping.sih",
        "ngsepcore_tpu_torch.imputation.genotype_imputer",
        "ngsepcore_tpu_torch.core.regions",
        "ngsepcore_tpu_torch.genome.builders",
        "ngsepcore_tpu_torch.vcf.analytics",
        "ngsepcore_tpu_torch.vcf.popgen",
        "ngsepcore_tpu_torch.vcf.converter",
        "ngsepcore_tpu_torch.clustering.trees",
        "ngsepcore_tpu_torch.graphs.mcl",
        "ngsepcore_tpu_torch.genome.homologs",
        "ngsepcore_tpu_torch.genome.synteny",
        "ngsepcore_tpu_torch.genome.genomes_aligner",
        "ngsepcore_tpu_torch.genome.transposons",
        "ngsepcore_tpu_torch.transcriptome.model",
        "ngsepcore_tpu_torch.transcriptome.protein",
        "ngsepcore_tpu_torch.transcriptome.gff3",
        "ngsepcore_tpu_torch.transcriptome.io_formats",
        "ngsepcore_tpu_torch.benchmark.gold_standard",
        "ngsepcore_tpu_torch.benchmark.quality_stats",
        "ngsepcore_tpu_torch.benchmark.sv_comparison",
        "ngsepcore_tpu_torch.simulation.tilling",
        "ngsepcore_tpu_torch.core.degenerate",
        "ngsepcore_tpu_torch.sequencing.trimmer",
        "ngsepcore_tpu_torch.sequencing.demultiplex",
        "ngsepcore_tpu_torch.transcriptome.annotator",
        "ngsepcore_tpu_torch.transcriptome.tools",
        "ngsepcore_tpu_torch.transcriptome.codon_alignment",
        "ngsepcore_tpu_torch.gbs.denovo",
        "ngsepcore_tpu_torch.gbs.translator",
        "ngsepcore_tpu_torch.gbs.uneak",
        "ngsepcore_tpu_torch.clustering.dbscan",
        "ngsepcore_tpu_torch.clustering.msa",
        "ngsepcore_tpu_torch.gwas.glm",
        "ngsepcore_tpu_torch.kernels.pairwise_simple",
        "ngsepcore_tpu_torch.align.pairwise_aligners",
        "ngsepcore_tpu_torch.distribute.mesh",
        "ngsepcore_tpu_torch.distribute.pipeline",
    ):
        assert mod in got["modules"]
    assert got["jax"] == []
    assert got["tpu"] == []
    assert got["triton"] == []
    assert got["built"] is False


_SCRIPT_PROBE = r"""
import importlib, json, sys
importlib.import_module(sys.argv[1])
loaded = lambda p: sorted(m for m in sys.modules if m == p or m.startswith(p + "."))
print(json.dumps({"jax": loaded("jax"), "tpu": loaded("ngsepcore_tpu")}))
"""


@pytest.mark.parametrize("script", ["chip_smoke", "gotoh_bench", "viterbi_bench", "walk_bench"])
def test_card_scripts_import_without_jax(script):
    """The scripts that run on the machine with the GPU import like the
    package: no jax, nothing of ngsepcore_tpu, nothing run at import."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT_PROBE, script],
        capture_output=True, text=True, env=env, cwd=root, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"jax": [], "tpu": []}
