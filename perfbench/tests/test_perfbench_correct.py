"""`correct` comes out false for the control and for every fault the cell
can have, with the rest of a run driven as the harness drives it (at a
tiny size on the CPU, with the harness's look for a card skipped), and true
for the sound run.  The readings at the cells' own sizes come from
perfbench/calibrate.py on the card."""
import pytest

from perfbench import check, control, harness, inputs


def _run(root, fault=None, seed=5):
    return harness.run_cell("tiny.fused", seed, 0.1, False, root=root, device="cpu",
                            fault=fault, log=lambda m: None)


def test_the_sound_run_is_correct(tiny_root):
    res = _run(tiny_root)
    assert res["correct"], res["checks"]
    assert res["checks"]["gl_mismatch"]["value"] == 0


@pytest.mark.parametrize("name", sorted(control.FAULTS))
def test_each_fault_is_refused(tiny_root, name):
    res = _run(tiny_root, control.FAULTS[name])
    assert not res["correct"], (name, res["checks"])


def test_the_control_is_refused(tiny_root):
    spec = harness.load_cell(tiny_root, "tiny.fused")
    cfg = spec["config"]
    ref = inputs.make_reference(cfg["reference"])
    sample = inputs.make_sample(ref, cfg["sample"], 5)
    judge = check.Judge(ref, sample, cfg)
    numbers = judge.numbers(check.compact(control.control_records(ref, sample, cfg)))
    ok, lines = check.verdict(numbers, spec["limits"])
    assert not ok, lines
    assert numbers["gl_mismatch"] > spec["limits"]["gl_mismatch"]
    # the same reference in float64 passes the genotype check
    exact = judge.numbers(check.compact(control.control_records(ref, sample, cfg, dtype=float)))
    assert exact["gl_mismatch"] == 0
