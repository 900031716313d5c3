"""Importing ngsepcore_tpu_torch must not load jax or ngsepcore_tpu (the
machine with the GPU has no jax), nor triton, nor build the CUDA kernels:
those are built at their first CUDA launch.  Checked in a fresh
interpreter so this test process's own imports do not interfere."""
import json
import os
import subprocess
import sys

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
    ):
        assert mod in got["modules"]
    assert got["jax"] == []
    assert got["tpu"] == []
    assert got["triton"] == []
    assert got["built"] is False
