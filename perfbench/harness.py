"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name BENCHMARK.json gives:

- perfbench/configs/<config>.json (BENCHMARK.json names the file): the
  reference, the sample and the caller's settings;
- perfbench/traffic/<traffic>.json: how the window feeds the program;
- perfbench/limits/<workload>.json: the limit of each number the check
  compares;
- perfbench/metrics/<metric>.py: the reader of a per-layer metric.

Set-up makes the traffic's `distinct_samples` samples from the run's seed
and warms up with the first.  The window then runs whole samples back to
back, each through a fresh AlignCallPipeline sharing the reference's index,
taking the samples in turn from the second, from its start until the
first sample that ends past `seconds`: no sample starts after `seconds`.
As each sample ends, its records become text (check.compact) and the
objects are dropped, as a user writes them out.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from collections import Counter
from pathlib import Path

from . import check, inputs, trace

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ngsepcore_tpu")


class SetupError(RuntimeError):
    """The checkout or the machine cannot run the cell."""


def load_cell(root: Path, workload: str) -> dict:
    """The workload's entry, its configuration, traffic and limits, and the
    per-layer and end-to-end metrics it reports."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SetupError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    base = root / "perfbench"

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(
        cell=cell,
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((base / "limits" / f"{workload}.json").read_text())["limits"],
        end_to_end=[m for m in spec["end_to_end"] if reports(m)],
        per_layer=[m for m in spec["per_layer"] if reports(m)],
    )


def nested_stages(root: Path) -> dict:
    out = {}
    for p in sorted((root / "perfbench" / "metrics").glob("nested_stages*.json")):
        out.update(json.loads(p.read_text())["nested"])
    return out


def metric_reader(root: Path, name: str):
    """The `read` function of perfbench/metrics/<name>.py."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def program_genome(ref: inputs.Reference):
    from ngsepcore_tpu_torch.core.genome import ReferenceGenome
    from ngsepcore_tpu_torch.core.sequences import QualifiedSequence, QualifiedSequenceList

    seqs = QualifiedSequenceList()
    for name, codes in zip(ref.names, ref.seqs):
        seqs.add(QualifiedSequence(name=name, codes=codes))
    return ReferenceGenome(seqs)


def program_reads(sample: inputs.Sample):
    from ngsepcore_tpu_torch.core.sequences import ReadBlock

    return ReadBlock(sample.codes, sample.lengths, None, sample.names,
                     default_quality=sample.base_quality)


class Program:
    """The system under test: the reference's index, and a fresh pipeline
    for every sample."""

    def __init__(self, genome, config: dict, traffic: dict, device):
        from ngsepcore_tpu_torch.index.minimizer_table import MinimizerTable

        self.genome = genome
        self.config = config
        self.traffic = traffic
        self.device = device
        self.table = MinimizerTable.build_from_genome(genome, device=device)
        self.table.device_arrays(device)

    def run(self, reads):
        from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner
        from ngsepcore_tpu_torch.call.fused_pipeline import AlignCallPipeline
        from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector

        call = self.config["caller"]
        det = SingleSampleVariantsDetector(
            self.genome, sample_id="s1", heterozygosity_rate=call["heterozygosity_rate"],
            min_quality=call["min_quality"], min_mq=call["min_mq"], device=self.device,
        )
        pipe = AlignCallPipeline(
            self.genome, aligner=ReadsAligner(self.genome, table=self.table, device=self.device),
            detector=det, batch_size=self.traffic["batch_size"], device=self.device,
        )
        return pipe.run_reads(reads)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class TraceHooks:
    """Turns on what a traced window records, and reads it back."""

    def __init__(self, tr: trace.Trace, device):
        import torch

        from ngsepcore_tpu_torch.kernels import genotyping, pairwise_cuda
        from ngsepcore_tpu_torch.utils import profiling

        self.tr, self.device = tr, device
        self.profiling = profiling
        self.gotoh = pairwise_cuda.gotoh_forward_plane
        self.genotyping = genotyping
        self.shear = genotyping.shear_hist
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.sampler = trace.HostSampler(tr.host_samples)

    def _counted_shear(self, stage_t, w0s, *, window, nq, lanes):
        self.tr.shear_calls[(int(window), int(lanes))] += 1
        return self.shear(stage_t, w0s, window=window, nq=nq, lanes=lanes)

    def __enter__(self):
        import torch

        self.profiling.reset()
        self.profiling.enable(True)
        self.shapes0 = Counter(self.gotoh.launch_shapes)
        self.genotyping.shear_hist = self._counted_shear
        if self.cuda:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.sampler.__enter__()
        return self

    def __exit__(self, *exc):
        self.sampler.__exit__(*exc)
        if self.prof is not None:
            self.prof.__exit__(*exc)
            self.tr.device_events = trace.read_device_events(self.prof)
        self.genotyping.shear_hist = self.shear
        self.profiling.enable(False)
        self.tr.stages = {k: list(v) for k, v in self.profiling._stages.items()}
        for (_ends, B, Lq, Ls, _kern), n in (Counter(self.gotoh.launch_shapes) - self.shapes0).items():
            self.tr.gotoh_shapes[(B, Lq, Ls)] += n
        return False


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def load_library(device) -> tuple[float, bool]:
    """Loads the program's CUDA library, building it first where the
    checkout has none: (seconds, whether it was built)."""
    import torch

    if torch.device(device).type != "cuda":
        return 0.0, False
    from ngsepcore_tpu_torch.kernels import cuda_build

    t0 = time.perf_counter()
    cuda_build.library()
    # nvcc's ptxas report is empty when the library was only loaded
    return time.perf_counter() - t0, bool(cuda_build.build_info.get("ptxas"))


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *, root: Path = ROOT,
             device: str = "cuda", t_start: float | None = None, fault=None,
             log=print) -> dict:
    """One run; returns the result line's object.  `fault`, when given,
    wraps the program's per-sample call (the tests' broken paths)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_cell(root, workload)
    cfg, traffic = spec["config"], spec["traffic"]
    cuda = torch.device(device).type == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < spec["cell"]["chips"]):
        raise SetupError(f"the cell needs {spec['cell']['chips']} CUDA card(s); "
                         f"available: {torch.cuda.is_available()}, "
                         f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}")

    build_s, built = load_library(device)
    ref = inputs.make_reference(cfg["reference"])
    genome = program_genome(ref)
    program = Program(genome, cfg, traffic, device)
    samples = [inputs.make_sample(ref, cfg["sample"], seed, k)
               for k in range(traffic["distinct_samples"])]
    reads = [program_reads(s) for s in samples]
    run = program.run if fault is None else fault(program.run)
    for _ in range(traffic["warmup_samples"]):
        run(reads[0])
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (CUDA library {'built' if built else 'loaded'} in "
        f"{build_s:.3f} s): {sum(map(len, ref.seqs))} bp in {len(ref.seqs)} sequence(s), "
        f"{len(samples)} samples of {len(samples[0])} reads")

    tr = trace.Trace(nested=nested_stages(root))
    outputs = []
    hooks = TraceHooks(tr, device) if traced else None
    if hooks:
        hooks.__enter__()
    try:
        w0, tr_w0 = time.perf_counter(), time.time_ns()
        while time.perf_counter() - w0 < seconds:
            k = (len(outputs) + 1) % len(samples)
            s0 = time.perf_counter()
            records = run(reads[k])
            sync(device)
            outputs.append((k, check.compact(records)))
            del records
            tr.sample_walls.append(time.perf_counter() - s0)
        w1, tr_w1 = time.perf_counter(), time.time_ns()
    finally:
        if hooks:
            hooks.__exit__(None, None, None)
    window = w1 - w0
    tr.window, tr.samples = (tr_w0, tr_w1), len(outputs)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    bad = forbidden_modules()
    if bad:
        raise SetupError(f"modules of JAX or of the JAX package are loaded: {bad}")
    n_reads = sum(len(samples[k]) for k, _ in outputs)
    log(f"window {window:.3f} s, {len(outputs)} sample(s), {n_reads} reads "
        f"({', '.join(f'{w:.3f}' for w in tr.sample_walls)} s)")
    del program, genome, run, reads
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    judges = [check.Judge(ref, s, cfg) for s in samples]
    numbers = check.judge_run(judges, outputs)
    correct, lines = check.verdict(numbers, spec["limits"])
    log(f"check {time.perf_counter() - t_check:.3f} s")

    values = {"reads_per_s": (n_reads / window, "reads/s"),
              "setup_s": (setup_s, "s")}
    metrics = {}
    if traced:
        for m in spec["per_layer"]:
            v = metric_reader(root, m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            v, unit = values[m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1 if cuda else 0,
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(outputs),
              "failed": 0 if correct else len(outputs), "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = trace.busy_ns(tr) * 1e-9 if tr.device_events else 0.0
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(tr),
                               "idle_gaps": trace.idle_by_host(tr)}
    if cuda:
        log(f"card: {power_limit()}")
    for line in lines:
        log(line)
    result["build_s"] = build_s
    result["checks"] = {k: {"value": numbers.get(k), "limit": spec["limits"].get(k)}
                        for k in sorted(set(numbers) | set(spec["limits"]))}
    return result


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start, log=log)
    except (SetupError, FileNotFoundError, ImportError) as e:
        log(f"perfbench: {type(e).__name__}: {e}")
        return 2
    print(json.dumps(result), flush=True)
    return 0


def cache_dirs(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout for PyTorch's extension
    builds and Triton (the program's own CUDA build goes to
    ngsepcore_tpu_torch/_build/, also inside the checkout)."""
    base = root / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")

