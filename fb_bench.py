"""Check and time the forward-backward kernel's two forms on one GPU.

    python3 fb_bench.py

csrc/forward_backward.cu has two forms of kernels/hmm.py posterior_log_batch:
the product form (fb_prepare_kernel, then fb_product_kernel: scaled linear
probabilities, a step one f64 DMMA product a block) for inputs that meet its
precondition, and the log form (forward_backward_kernel: an exp10 a cell)
for any input.  On the imputer's E-step input (chip_smoke._imputer_window,
K 8, S 64) this script:

1. lists the log form's local-memory stores and loads (STL, LDL) in the
   SASS of the package's library, with the instructions before each
   (cuobjdump), and ptxas' spill report for each kernel; then measures the
   FP64 tensor cores' rate by mma.sync f64 shape (dmma_rates: m8n8k4, the
   product form's, and Hopper's m16n8k4, m16n8k8, m16n8k16);
2. is the same-card A/B of the two forms at n 300 x T 5,000 (a window of
   NGSEP's defaults) and at T 1,000 with n 32, 64, 132, 300, 600 and 1,200:
   the product form at 8 and 16 samples a block (each bit for bit
   against the package's own call) and the log form at its default layout,
   both held against each other (FB_POST_TOL, FB_LL_RTOL), timed in rounds
   in order and then in reverse (chip_smoke.cuda_ms), so that a drift of
   the card's clock shows as a difference of the rounds;
3. builds the source alone with each ablation macro and times its product
   kernel at n 300 x T 5,000 beside the whole build, in rounds A B .. B A:
   FB_ABLATE_DELIVERY (every step reads the first matrix's B fragments,
   loaded once: no P delivery), FB_ABLATE_PRODUCTS (no DMMAs),
   FB_ABLATE_EXCHANGE (every
   step reads the same input rows, so no step waits on the one before; the
   barrier stays), FB_ABLATE_BACKWARD (the forward pass and ll alone),
   FB_ABLATE_POSTERIOR (the recursions without the posterior pass),
   FB_ABLATE_STORES (no a^ and u stored by the steps), FB_ABLATE_ROWS (no
   E^ and a^ rows and no offsets staged); and the ring at 2, 3
   and 5 stages (FB_STAGES; 4 in the package), which says how far the
   staged loads' latency sets a step's pace.  An ablated build computes
   something else, so only its time is kept.

Prints the card's name and power limit, one line a measurement, and last a
JSON object of the medians.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from chip_smoke import (FB_LL_RTOL, FB_POST_TOL, _fb_disagreement, _imputer_window, cuda_ms,
                        fail, nvidia_smi)
from ngsepcore_tpu_torch.kernels import cuda_build, hmm

# ablation and variant builds: name -> the lines put before the source
BUILDS = {a: f"#define FB_ABLATE_{a}\n" for a in (
    "DELIVERY", "PRODUCTS", "EXCHANGE", "BACKWARD", "POSTERIOR", "STORES", "ROWS")}
BUILDS.update({f"STAGES={k}": f"#define FB_STAGES {k}\n" for k in (2, 3, 5)})
ROWS = (8, 16)
K = 8


def sass_local_memory(so_path: str, name: str = "forward_backward_kernel", before: int = 4):
    """{function: [the STL / LDL instructions, each after the `before`
    instructions that precede it]} of the functions named `name`."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                         timeout=300).stdout
    found, fn, recent = {}, None, []
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if name in m.group(1) else None
            recent = []
            continue
        if fn is None:
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4})\*/\s+(.*?)\s*;?\s*/\*", line)
        if not m:
            continue
        ins = f"{m.group(1)}: {m.group(2)}"
        if re.search(r"\b(STL|LDL)\b", m.group(2)):
            found.setdefault(fn, []).append(recent[-before:] + [ins])
        recent.append(ins)
    return found


# The FP64 tensor-core rate of each mma.sync f64 shape at full load: kind 0
# m8n8k4, 1 m16n8k4, 2 m16n8k8, 3 m16n8k16; eight warps a block, one block
# an SM, each warp a loop of kAcc independent accumulators (so the rate, not
# the latency, is measured), the block's clock span over its flops.
DMMA_RATE_CU = r"""
#include <cuda_runtime.h>

namespace {
constexpr int kAcc = 8;

template <int kKind>
__global__ void __launch_bounds__(256, 1)
dmma_rate_kernel(int reps, long long* span, double* sink) {
  double a[8], b[4], d[kAcc][4];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = 1.0 + 1e-3 * ((threadIdx.x + k) & 7);
#pragma unroll
  for (int k = 0; k < 4; ++k) b[k] = 1.0 - 1e-3 * ((threadIdx.x + k) & 3);
#pragma unroll
  for (int j = 0; j < kAcc; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) d[j][k] = 0.0;
  __syncthreads();
  long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      if (kKind == 0)
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
                     : "+d"(d[j][0]), "+d"(d[j][1]) : "d"(a[0]), "d"(b[0]));
      else if (kKind == 1)
        asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
                     : "+d"(d[j][0]), "+d"(d[j][1]), "+d"(d[j][2]), "+d"(d[j][3])
                     : "d"(a[0]), "d"(a[1]), "d"(b[0]));
      else if (kKind == 2)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                     : "+d"(d[j][0]), "+d"(d[j][1]), "+d"(d[j][2]), "+d"(d[j][3])
                     : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};"
                     : "+d"(d[j][0]), "+d"(d[j][1]), "+d"(d[j][2]), "+d"(d[j][3])
                     : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
                       "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
    }
  }
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
  __syncthreads();
  long long t1 = clock64();
  if (threadIdx.x == 0) {
    span[2 * blockIdx.x] = t0;
    span[2 * blockIdx.x + 1] = t1;
  }
}
}  // namespace

extern "C" int dmma_rate(int kind, int blocks, int reps, void* span, void* sink) {
  long long* sp = (long long*)span;
  double* s = (double*)sink;
  if (kind == 0) dmma_rate_kernel<0><<<blocks, 256>>>(reps, sp, s);
  else if (kind == 1) dmma_rate_kernel<1><<<blocks, 256>>>(reps, sp, s);
  else if (kind == 2) dmma_rate_kernel<2><<<blocks, 256>>>(reps, sp, s);
  else dmma_rate_kernel<3><<<blocks, 256>>>(reps, sp, s);
  return (int)cudaGetLastError();
}
"""
DMMA_SHAPES = (("m8n8k4", 8 * 8 * 4), ("m16n8k4", 16 * 8 * 4), ("m16n8k8", 16 * 8 * 8),
               ("m16n8k16", 16 * 8 * 16))


def dmma_rates(reps: int = 2048) -> dict:
    """{shape: (SM cycles an instruction of one SMSP, FP64 multiply-adds a
    cycle of an SM)} of each mma.sync f64 shape at full load (DMMA_RATE_CU):
    the median over blocks of the clock span over the instructions a
    sub-partition issued (two warps x 8 accumulators x reps)."""
    import ctypes

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / "dmma_rate.cu"
    src.write_text(DMMA_RATE_CU)
    lib, _ = cuda_build.build([src], stem="libdmma_rate")
    fn = lib.dmma_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    span = torch.zeros((blocks, 2), dtype=torch.int64, device="cuda")
    sink = torch.empty(blocks * 256, dtype=torch.float64, device="cuda")
    out = {}
    for kind, (name, fma) in enumerate(DMMA_SHAPES):
        best = float("inf")
        for _ in range(3):
            cuda_build.check("dmma_rate", fn(kind, blocks, reps, span.data_ptr(), sink.data_ptr()))
            torch.cuda.synchronize()
            cyc = (span[:, 1] - span[:, 0]).double().cpu().numpy()
            best = min(best, float(np.median(cyc)) / (2 * 8 * reps))
        out[name] = (best, 4 * fma / best)
    return out


def product(lib, args, rows, prep=None):
    """The product form of `lib` at `rows` samples a block: (post, ll)."""
    start, trans, emit = args
    prep = prep if prep is not None else hmm._fb_prepare(lib, start, trans, emit)
    return hmm._fb_product(lib, start, prep, emit, trans.shape[0] != 1, rows // 8)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = nvidia_smi()
    print(smi, flush=True)
    lib = cuda_build.library()
    name = ""
    for line in cuda_build.build_info["ptxas"].splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif ("spill" in line or "registers" in line) and ("fb_" in name
                                                           or "forward_backward" in name):
            print(f"ptxas {name}: {line.strip()}", flush=True)
    for fn, sites in sass_local_memory(cuda_build.build_info["path"]).items():
        print(f"SASS {fn}: {len(sites)} local-memory instructions", flush=True)
        for site in sites:
            print("   " + " | ".join(site), flush=True)

    for name, (cyc, rate) in dmma_rates().items():
        print(f"mma.sync {name}.f64 at full load: {cyc:.2f} cycles an instruction of a "
              f"sub-partition, {rate:.1f} FP64 multiply-adds a cycle of an SM ({smi})", flush=True)

    # ablation builds, all at once
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = (cuda_build.CSRC / "forward_backward.cu").read_text()
    variants = []
    for k, (name, prefix) in enumerate(BUILDS.items()):
        path = cuda_build.BUILD_DIR / f"fb_variant{k}.cu"
        path.write_text(prefix + src)
        variants.append(path)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda p: cuda_build.build([p], stem=f"lib{p.stem}")[0], variants))
    ablated = dict(zip(BUILDS, built))

    rng = np.random.default_rng(12)
    result = {"card": smi, "shapes": {}, "ablations_ms": {}}
    shapes = [(300, 5000)] + [(n, 1000) for n in (32, 64, 132, 300, 600, 1200)]
    for n, T in shapes:
        args = _imputer_window(rng, n, T, K)
        want = hmm.posterior_log_batch(*args)  # the package's own call
        log_form = hmm.posterior_log_batch(*args, form="log")
        err, rel, same_inf = _fb_disagreement(want, log_form)
        if err > FB_POST_TOL or rel > FB_LL_RTOL or not same_inf:
            fail(f"the two forms disagree at n={n} T={T}: {err:.3e}, {rel:.3e}")
        for rows in ROWS:
            got = product(lib, args, rows)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                fail(f"{rows} samples a block changed the result at n={n} T={T}")
        del want, log_form, got
        prep = hmm._fb_prepare(lib, *args)
        fns = {f"product {rows}": (lambda rows=rows: product(lib, args, rows, prep))
               for rows in ROWS}
        fns["prepare"] = lambda: hmm._fb_prepare(lib, *args)
        fns["log"] = lambda: hmm.posterior_log_batch(*args, form="log")
        ms = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                reps, calls = (3, 3) if k != "log" or T < 5000 else (2, 2)
                ms[k].append(cuda_ms(fns[k], reps=reps, calls=calls))
        med = {k: float(np.median(v)) for k, v in ms.items()}
        auto = hmm.product_tiles(n, args[2].device) * 8
        print(f"n={n} T={T} S={K * K} ({smi}): the product form's default {auto} a block; "
              f"its prologue {med['prepare']:.4f} ms; ms (in order, reverse): "
              + ", ".join(f"{k} {v[0]:.4f}, {v[1]:.4f}" for k, v in ms.items())
              + f"; log / product {auto}: {med['log'] / med[f'product {auto}']:.1f}x", flush=True)
        result["shapes"][f"n={n} T={T} S={K * K}"] = med
        if (n, T) == (300, 5000):
            builds = [("whole", lib)] + list(ablated.items())
            order = [b for b in builds] + builds[::-1]
            times = {k: [] for k, _ in builds}
            for k, blib in order:
                prep_k = hmm._fb_prepare(blib, *args)
                times[k].append(cuda_ms(lambda: product(blib, args, 8, prep_k), reps=3, calls=3))
            whole = float(np.median(times["whole"]))
            for k, v in times.items():
                m = float(np.median(v))
                print(f"  ablation {k} at 8 a block: {m:.4f} ms (runs {', '.join(f'{x:.4f}' for x in v)}"
                      f"); {100 * (m / whole - 1):+.1f}% of the whole build ({smi})", flush=True)
                result["ablations_ms"][k] = m
        del args, prep
        torch.cuda.empty_cache()
    print(nvidia_smi(), flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
