"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level names: ngsepcore_tpu_torch begins with ngsepcore_tpu), and
the yardstick (inputs, reference, comparison, control, peaks, trace)
loads nothing of the port."""
import json
import subprocess
import sys

import pytest

from perfbench.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "ngsepcore_tpu"}


def _modules_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_tiny_run_loads_no_jax(tiny_root):
    code = (
        "from pathlib import Path\n"
        "from perfbench import harness\n"
        f"r = harness.run_cell('tiny.fused', 5, 0.1, True, root=Path({str(tiny_root)!r}),"
        " device='cpu', log=lambda m: None)\n"
        "assert r['correct'] and r['metrics'], r\n"
    )
    mods = _modules_after(code)
    assert "ngsepcore_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_the_yardstick_loads_nothing_of_the_program():
    code = (
        "import numpy as np\n"
        "from perfbench import check, control, inputs, peaks, reference, trace\n"
        "ref = inputs.make_reference({'sequences': [['a', 30000], ['b', 20000]],"
        " 'genome_seed': 1, 'repeat_families_per_12mbp': 30, 'tandem_arrays_per_12mbp': 400})\n"
        "cfg = {'sample': {'coverage': 6, 'read_length': 150, 'error_rate': 0.003,"
        " 'base_quality': 40, 'snv_rate': 0.001, 'indel_rate': 0.0001},"
        " 'caller': {'heterozygosity_rate': 0.001, 'min_quality': 40}}\n"
        "s = inputs.make_sample(ref, cfg['sample'], 9)\n"
        "recs = control.control_records(ref, s, cfg)\n"
        "print(check.Judge(ref, s, cfg).numbers(check.compact(recs)))\n"
    )
    mods = _modules_after(code)
    assert not mods & (FORBIDDEN | {"ngsepcore_tpu_torch", "torch"})


@pytest.mark.cuda
def test_a_tiny_run_on_the_card_loads_no_jax(tiny_root):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code = (
        "from pathlib import Path\n"
        "from perfbench import harness\n"
        f"r = harness.run_cell('tiny.fused', 5, 0.1, True, root=Path({str(tiny_root)!r}),"
        " device='cuda', log=lambda m: None)\n"
        "assert r['correct'] and r['device']['busy_s'] > 0, r\n"
    )
    assert not _modules_after(code) & FORBIDDEN
