"""Readings that the limits of a cell are set from, at the cell's own size.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out readings.jsonl]

In one process (the reference and its index are built once): for each of
`--seeds`, one sample through the program and the numbers of the
comparison (the sound runs, whose largest reading is each number's lower
one); for each of `--control-seeds`, the control (control.py: the plain
reference in float32 in the program's place); for each of `--fault-seeds`,
the faults of control.FAULTS.  One JSON line a reading on standard output
(and in --out), then the lower reading of each number and the smallest of
the control's and the faults' readings.  Needs the cell's CUDA card; the
benchmark's own runs never run this.
"""
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if not __package__:  # run as a script: the checkout's root in place of this directory
    sys.path[0] = str(ROOT)

from perfbench import check, control, harness, inputs  # noqa: E402


def readings(workload: str, seeds, control_seeds, fault_seeds, *, root=ROOT,
             device="cuda", emit=print) -> list[dict]:
    spec = harness.load_cell(root, workload)
    cfg, traffic = spec["config"], spec["traffic"]
    ref = inputs.make_reference(cfg["reference"])
    genome = harness.program_genome(ref)
    program = harness.Program(genome, cfg, traffic, device)
    out = []

    def record(seed, kind, numbers, **extra):
        row = dict(workload=workload, seed=seed, kind=kind, numbers=numbers, **extra)
        out.append(row)
        emit(json.dumps(row))

    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        sample = inputs.make_sample(ref, cfg["sample"], seed)
        reads = harness.program_reads(sample)
        judge = check.Judge(ref, sample, cfg)
        sound = None
        if seed in seeds or seed in fault_seeds:
            t0 = time.perf_counter()
            sound = program.run(reads)
            harness.sync(device)
            wall = time.perf_counter() - t0
            if seed in seeds:
                record(seed, "program", judge.numbers(check.compact(sound)),
                       sample_s=wall, records=len(sound))
        if seed in control_seeds:
            recs = control.control_records(ref, sample, cfg)
            record(seed, "control", judge.numbers(check.compact(recs)), records=len(recs))
        if seed in fault_seeds:
            for name, fault in control.FAULTS.items():
                if name == "half_reads":
                    got = fault(program.run)(reads)
                else:  # the other faults act on the answers: the sound run's, copied
                    got = fault(lambda _reads: copy.deepcopy(sound))(reads)
                record(seed, name, judge.numbers(check.compact(got)), records=len(got))
    return out


def summary(rows: list[dict]) -> dict:
    """Each number's lower reading (largest of the sound runs) and the
    smallest reading of the control and of each fault."""
    out: dict = {}
    for row in rows:
        for name, v in row["numbers"].items():
            d = out.setdefault(name, {})
            if row["kind"] == "program":
                d["lower"] = max(d.get("lower", v), v)
            else:
                d[row["kind"]] = min(d.get(row["kind"], v), v)
    return out


def main() -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out")
    args = p.parse_args()

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    harness.cache_dirs()
    rows = readings(args.workload, ints(args.seeds), ints(args.control_seeds),
                    ints(args.fault_seeds))
    summ = summary(rows)
    print(json.dumps({"summary": summ}))
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows)
                                  + json.dumps({"summary": summ}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
