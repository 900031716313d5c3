"""Kernel S (csrc/shear_hist.cu): the least time its launches' work needs
at the card's peaks (peaks.shear_bound_s over each call's window and
lanes) over the device time of its kernel, in percent."""
from perfbench.peaks import shear_bound_s
from perfbench.trace import kernel_seconds


def read(tr):
    spent = kernel_seconds(tr, "shear_hist")
    if spent <= 0 or not tr.shear_calls:
        return None
    need = sum(n * shear_bound_s(w, lanes) for (w, lanes), n in tr.shear_calls.items())
    return 100.0 * need / spent
