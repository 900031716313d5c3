"""Fixtures of the benchmark's own tests: a tiny cell in a scratch
checkout, which the harness finds by name like any other."""
import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
# two sequences of 100 kb: 15,000 reads a sample at the yeast coverage
TINY_SEQUENCES = [["chrI", 100_000], ["chrII", 100_000]]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


def make_root(root: Path, extra_metric: str | None = None, traffic: dict | None = None) -> Path:
    """A checkout holding BENCHMARK.json with one cell, `tiny.fused`: the
    yeast configuration on TINY_SEQUENCES, under the yeast cell's limits; with `extra_metric` one more per-layer metric
    whose reader is the given source, and with `traffic` a second cell,
    `tiny.dummy`, under that traffic mix."""
    pb = root / "perfbench"
    for d in ("configs", "traffic", "limits"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", pb / "metrics", dirs_exist_ok=True)
    shutil.copy(BENCH / "traffic" / "fused.json", pb / "traffic" / "fused.json")
    shutil.copy(BENCH / "limits" / "yeast_wgs.fused.json", pb / "limits" / "tiny.fused.json")
    cfg = json.loads((BENCH / "configs" / "yeast_wgs.json").read_text())
    cfg["name"] = "tiny"
    cfg["reference"]["sequences"] = TINY_SEQUENCES
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [dict(spec["configs"][0], name="tiny", file="perfbench/configs/tiny.json")]
    spec["workloads"] = [dict(spec["workloads"][0], name="tiny.fused", config="tiny")]
    for m in spec["per_layer"]:
        m["workloads"] = ["tiny.fused", "tiny.dummy"]
    if extra_metric:
        (pb / "metrics" / "samples_done.py").write_text(extra_metric)
        spec["per_layer"].append({
            "name": "samples_done", "unit": "samples", "better": "higher",
            "source": "program_counter", "layer": "pipeline orchestration", "moves": "reads_per_s"})
    if traffic:
        (pb / "traffic" / "dummy.json").write_text(json.dumps(traffic))
        shutil.copy(BENCH / "limits" / "yeast_wgs.fused.json", pb / "limits" / "tiny.dummy.json")
        spec["workloads"].append(dict(spec["workloads"][0], name="tiny.dummy", traffic="dummy"))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))
