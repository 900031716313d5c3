"""Sweep the samples a block of the forward-backward kernel on one GPU.

    python3 fb_bench.py

csrc/forward_backward.cu runs G sequences in a block of G x ceil(S/32) x 32
threads; the package takes as many as fill kernels/hmm.py FB_BLOCK_THREADS
(256: four at S 64).  This script calls the kernel's C entry with each G
directly, holds every G's posteriors and log-likelihoods bit for bit
against the package's own call (the layout changes no arithmetic), and
times each G with CUDA events (chip_smoke.cuda_ms) on the imputer's E-step
input (chip_smoke._imputer_window): at n 300 x T 5,000 x S 64, a window of
NGSEP's defaults, with G 1, 2, 3, 4 and 8, and at T 1,000 with n 32, 64,
132, 600 and 1,200 and G 1, 2, 4 and 8.  Each shape is timed in two rounds,
the Gs in order and then in reverse, so that a drift of the card's clock
shows as a difference of the rounds.  Prints the card's name and power
limit, then one line a shape; the last line is a JSON object of the
medians.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from chip_smoke import _imputer_window, cuda_ms, fail, nvidia_smi
from ngsepcore_tpu_torch.kernels.cuda_build import check, library
from ngsepcore_tpu_torch.kernels.hmm import posterior_log_batch


def run(args, G: int):
    """One launch of the kernel with G sequences a block: (post, ll)."""
    start, trans, emit = args
    n, T, S = emit.shape
    post = torch.empty_like(emit)
    ll = torch.empty(n, dtype=torch.float64, device=emit.device)
    rc = library().forward_backward_launch(
        start.data_ptr(), trans.data_ptr(), emit.data_ptr(), n, T, S,
        int(trans.shape[0] != 1), G, post.data_ptr(), ll.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    check("forward_backward_launch", rc)
    return post, ll


def sweep(args, gs) -> dict:
    """{G: [ms in order round, ms in reverse round]} after holding each G's
    result against posterior_log_batch's."""
    want = posterior_log_batch(*args)
    for G in gs:
        got = run(args, G)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"{G} samples a block changed the result at {tuple(args[2].shape)}")
    del want, got
    ms = {G: [] for G in gs}
    for order in (list(gs), list(gs)[::-1]):
        for G in order:
            ms[G].append(cuda_ms(lambda: run(args, G), reps=3, calls=3))
    return ms


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = nvidia_smi()
    print(smi, flush=True)
    rng = np.random.default_rng(12)
    K = 8
    result = {}
    shapes = [(300, 5000, (1, 2, 3, 4, 8))] + [
        (n, 1000, (1, 2, 4, 8)) for n in (32, 64, 132, 600, 1200)]
    for n, T, gs in shapes:
        args = _imputer_window(rng, n, T, K)
        ms = sweep(args, gs)
        del args
        med = {G: float(np.median(v)) for G, v in ms.items()}
        best = min(med.values())
        print(f"n={n} T={T} S={K * K} ({smi}): ms by samples a block (order, reverse): "
              + ", ".join(f"{G}: {v[0]:.3f}, {v[1]:.3f} (+{100 * (med[G] / best - 1):.1f}%)"
                          for G, v in ms.items()), flush=True)
        result[f"n={n} T={T} S={K * K}"] = {str(G): v for G, v in med.items()}
    print(json.dumps({"card": smi, "ms_by_samples_a_block": result}), flush=True)


if __name__ == "__main__":
    main()
