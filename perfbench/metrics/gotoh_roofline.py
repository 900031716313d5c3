"""Kernel G (csrc/gotoh_forward.cu): the least time its launches' work
needs at the card's peaks (peaks.gotoh_bound_s over the padded launch
shapes that gotoh_forward_plane counts) over the device time of its kernels,
in percent."""
from perfbench.peaks import gotoh_bound_s
from perfbench.trace import kernel_seconds


def read(tr):
    spent = kernel_seconds(tr, "gotoh_forward")
    if spent <= 0 or not tr.gotoh_shapes:
        return None
    need = sum(n * gotoh_bound_s(B, Lq, Ls) for (B, Lq, Ls), n in tr.gotoh_shapes.items())
    return 100.0 * need / spent
