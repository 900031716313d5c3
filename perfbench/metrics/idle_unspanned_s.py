"""Pipeline orchestration, seen from the device: seconds a sample in which
the device sat idle (trace.gaps) while a sample's request was open and no
stage of the program was (the program's spans and requests, on the clock
of the device events)."""
from perfbench.ledger import idle_outside_spans_ns, program_ledger
from perfbench.trace import gaps


def read(tr):
    led = program_ledger()
    if led is None or not tr.device_events or not tr.samples:
        return None
    reqs = led.requests()
    if not reqs:
        return None
    return idle_outside_spans_ns(gaps(tr), reqs, led.spans(), tr.window) * 1e-9 / tr.samples
