"""Smoke run of ngsepcore_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 20,21] [--asm-row A]

Builds the CUDA kernels from ngsepcore_tpu_torch/csrc (first use), holds
each against its plain PyTorch version on the card, full plane and edge
shapes included, and times it beside its bound (phases 2-3), checks
the fused align+call pipeline on CUDA against the same pipeline on the CPU
(phase 4), runs it at a bacterial-isolate WGS size (4.6 Mbp diploid
genome with repeat families and tandem arrays, 345,000 x 150 bp reads,
11.25x) with bench.py's accuracy gates (phase 5), checks the classic
two-stage flow (phase 6) and the span-scatter genotyper (phase 7) on CUDA
against the CPU at 50 kb, and runs the CLI (ReadsAligner -> SAM ->
SingleSampleVariantsDetector -> VCF, as subprocesses) on phase 5's data
with the same gates (phase 8).  The known-STR path follows: fused and
classic with a catalogue of planted tandem arrays on CUDA against the CPU
at 50 kb (phase 9), and phase 5's genome and reads again with its 153
tandem arrays as the catalogue (phase 10), whose reads over an array take
the tier-2 split alignment through the Gotoh kernel's free query ends;
every shape that this run launched with a free query end is then checked
and timed on its own, which gives the run's tier-2 kernel time.
Phase 11 runs the k-mer commands of the CLI on phase 8's FASTQ and FASTA
(KmersExtractor, k = 15, both strands, with its counting invariants and
CUDA against CPU) and ReadsFileErrorsCorrector on the first 20,000 reads.
The population and read-depth callers follow.  Phase 2b measures the
latency of each link of a Viterbi step's chain (the bound), holds the
Viterbi kernel bit for bit against its plain version (shared and per-step
transitions, -inf entries, a tie, signed zeros, T = 1 to 120,000, S = 1
to 32, ragged batches of one launch), times it at the 46,000 bins of the
4.6 Mbp genome, decodes a human genome's 24 sequences in 100 bp bins in
one launch beside their 24 own launches, and runs find_cnv_calls over
three sequences on the card against the CPU (one launch and one
device-to-host copy an HMM algorithm).  Phase 12 checks, CUDA against CPU at
50 kb, MultisampleVariantsDetector on 3 samples, the four read-depth CNV
algorithms, the detector's read-pair SV stage and the four new CLI
commands.  Phase 13 calls 3 individuals of phase 5's genome jointly (6x
each, 552,000 reads) and runs the four CNV algorithms on the one that
carries a 20 kb duplication and a 10 kb deletion, with accuracy gates.
The long-read path follows.  Phase 2c holds the run-jump walk kernel
(csrc/run_walk.cu, behind every Gotoh launch) in its three modes against
the plain composites (runs: the plain walk; tier3: the plain walk then
dp_stats_runs; hamming: then dp_stats_runs_hamming) on Gotoh planes of
every path's shapes and of the edges (tier 2's budget, saturated runs,
exhausted budgets, empty queries, a plane past 2^31 cells) and on
synthetic planes for the left-alignment's edges, and times each path's
mode in CUDA graphs beside what it replaces; the main-path phases fail
unless every walk launch took the path's mode, one a Gotoh launch, and
phases 4, 6 and 14 run their CUDA side with the plain walk and
post-passes made to raise; phase 14 runs LongReadsAligner and
the long-read SV caller at 60 kb on CUDA against the CPU, in process and
through the CLI (ReadsAligner -p PACBIO, SingleSampleVariantsDetector
-runLongReadSVs), with a planted insertion and deletion to find; phase
15 aligns bench_configs.bench_long_reads' 600 reads of 10 kb against
4 Mbp with its accuracy gates, then calls long-read SVs on them.
Phase 2 also holds the seg Gotoh kernel (256 < Ls <= 3,584), the cluster
kernel (a thread-block cluster an alignment, up to 24,576: by shape at
3,585-24,576 in the paths' four free-end configurations, on a batch of
more than one wave, and forced on every case wider than 256 columns) with
the clusters the card holds at once, and the wide one (above; forced at
every narrower case); phase 9's
genome carries a 1,500 bp tandem array whose flanks take the seg kernel,
and phase 9 also runs the known-STR detector through the CLI, CUDA against
the CPU.  De-novo assembly follows: phase 16 runs the
reference's legacy assembler row (30 kb, 15x of 2.5 kb reads) and a
ploidy-2 assembly on the card against the CPU, Assembler,
AssemblyGraphStatistics and SIH through the CLI; phase 17 assembles
bench_configs.py's 100 kb linearity row (30x of 10 kb reads) on the card
with an identity gate, its stage times and launches (`--asm-row A`: scale
row A, 60x of 15 kb reads over 300 kb, instead).
The imputer follows.  Phase 2d holds the forward-backward kernel
(csrc/forward_backward.cu, the imputer's E-step) against its batched plain
loop (S 1 to 1,024, shared and per-step transitions, a dead state, -inf
transitions, emissions past the product form's range): every case must
take the form its precondition names and agree in it (the product form at
8 and 16 samples a block, the log form at 1 to 32 on every case); both
forms are then timed at the imputer's window (300 samples x 5,000 sites,
S 64) beside the floor of the function and the plain loop (fb_bench.py
has the same-card A/B at other batch sizes and the ablations); phase 18
runs tests/test_imputation.py's two workloads
on CUDA against the CPU, in process and through VCFImpute, and the VCF
downstream commands on the imputed VCF (VCFFilter, VCFSummaryStats,
VCFDistanceMatrixCalculator -> NeighborJoining, VCFConverter,
VCFComparator); phase 19 imputes 300 samples x 20,000 SNVs at NGSEP's
defaults (5 windows, 55 launches, all of the product form) with the JAX
test's accuracy gate and its host stages timed.
The benchmark tools, reads processing and genome comparison follow (no
kernel of their own: MCL's steps and the repeat finder's minimizers run as
torch on the card).  Phase 20 runs their eight commands through the CLI on
CUDA and on the CPU side by side (VCFGoldStandardComparator, the three
TILLING commands, Demultiplex, GenomesAligner, CDNACatalogAligner on
protein and cDNA catalogs, TransposonsFinder in both modes), every output
file byte-equal, then mcl_cluster on a 2,000-node block matrix, clusters
equal; phase 21 runs TransposonsFinder's two modes on
bench.build_repeat_genome(rng 2024, 12 Mbp) with the 30 family source
segments as the library (GFF equal to the CPU's; library covered share >=
0.98 and precision >= 0.99, de-novo precision >= 0.95, over the families'
source and copy intervals) and CDNACatalogAligner on three catalogs of
2,000 proteins (orthogroups equal to the CPU's, >= 1,400 of 1,600
orthologs as exact triples), with stage seconds, call counts and peak
device memory.
The transcriptome, GBS and pairwise-aligner long tail follows (no kernel of
its own: de-novo GBS runs as torch on the card, the MSA on the Gotoh
kernel and the walk).  Phase 22 runs the seven commands of items 17f and
17g through the CLI on CUDA and on the CPU side by side (VCFAnnotate,
TranscriptomeAnalyzer, TranscriptomeFilter, MutatedPeptidesExtractor,
DeNovoGBS, VCFRelativeCoordinatesTranslator, UneakToVCFConverter), every
output file and standard output byte-equal, then in process the MSA of 40
sequences, the simple-gap and banded DPs on 1,024 pairs, dp_stats_pack on
a tier-3 chunk, the GLM on 300 samples x 5,000 SNVs and DBSCAN, CUDA
against the CPU; phase 23 runs DeNovoGBS on a 24-sample ApeKI lane of
10,000 loci of the 12 Mbp bench genome (1.9 M reads; SNV precision >=
0.90 and recall >= 0.80 over the planted SNVs, the first 1,000 clusters'
records equal to the CPU's, stage seconds, peak device memory), then the
best-star MSA of each of the genome's 30 repeat families (rows of one
width that are their inputs with gaps, the 5 smallest and the smallest
over 3,584 bp CUDA = CPU, Gotoh launches by kernel and shape, the batch
with the most cells and the cluster kernel's timed beside their plain
version and bound).
The sorted-key seed table (the MinimizerTable layout past 2^24 distinct
minimizers) follows.  Phase 4 also runs its 50 kb input fused and classic
with the layout forced (MinimizerTable.MAX_BUCKETIZED_CODES set low on the
class): records, SAM lines and the seeds of 2,048 reads on CUDA equal to
the CPU's; and tests/test_accuracy_anchor.py's 30x of 150 bp reads over
250 kb through the fused pipeline on CUDA with its gates (SNV recall and
precision >= 0.95, indel recall >= 0.90).  Phase 24 runs phase 5's
individual and reads against a rice-sized reference (phase 5's genome as
chr1 and eleven random sequences, 373.2 Mbp in 12 sequences, the size and
count of IRGSP-1.0), whose more than 2^24 distinct codes take the
sorted-key layout by themselves: index build seconds, table bytes, the
culled codes, reads/s, stage seconds, peak device memory, bench.py's gates
and the records that differ from phase 5's.
The multi-device path follows (ngsepcore_tpu_torch/distribute, no kernel
of its own).  Phase 25 runs ShardedAlignCallPipeline on a mesh of two
shards of the card against two shards of the CPU on phase 4's 50 kb input
(records equal to each other and to phase 4's unsharded ones), the CUDA
run's first window through the sharded span kernel, its first tier-3 group
through the sharded sweep and sharded_call_step on 2,048 reads on both
meshes; then phase 5's genome, reads and index on cuda:0 x D for D = 1, 2,
4 and 4 again: records identical at every D and to phase 5's, bench.py's
gates, every shard launching the Gotoh kernel and the walk, no
shear-histogram launch; wall, stage seconds, launches and host syncs by
shard and peak device memory for each D.  Shards of one card are the
counterpart of the JAX tests' virtual CPU devices, not a scaling claim.
Phase 26 runs bench.py's workload through the fused flagship: the 12 Mbp
genome of bench.build_repeat_genome(rng 2024) (30 families, 400 tandem
arrays), one diploid individual, 900,000 x 150 bp reads (11.25x), its own
index, a warm-up and one timed run at batch 65,536: bench.py's gates, the
Gotoh kernel, the walk and the shear kernel launched, and the records'
digest (records_digest) equal to BENCH_SIZE_RECORDS, the JAX package's
records on the CPU (tests/test_torch_bench_workload.py holds both
packages' CPU records to it); wall, reads/s, stage seconds, peak device
memory and the Gotoh and walk launch shapes beside the card's name and
power limit.  Phase 5 holds its records to PHASE5_RECORDS the same way.
With --phases only the listed phases run (and the ones whose data they
use; 0 and 1 always run).
Prints one line per phase and exits nonzero at the first failure.  The
last lines are a JSON object of the kernels (launch counts from the timed
runs of phases 5, 6, 9, 10, 13, 15, 17, 19, 23, 24, 25 (its first D = 4 run, by
shard too) and 26, errors and times measured here; the
tier-2 and long-read entries at the launched shape that takes most of
their time), the card's name and power limit, and the result line.  A kernel's bound is the least time the card could take: the
larger of its bytes (inputs read once, outputs written once) over the
memory rate and its integer operations over the INT32 issue rate (for the
Viterbi kernel: its serial chain of dependent instructions over the clock;
for the walk: its longest chain of dependent loads at one L2 hit each; for
the forward-backward kernel: the floor of the function in any design, the
largest of its bytes, its products on the FP64 tensor cores, its exp10 and
log10 on the FP64 lanes and its chain of a step).

Imports torch, numpy and the port only (bench.py's gates are numpy).
"""
from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 5, calls: int = 1) -> float:
    """Median of `reps` CUDA-event timings of `calls` back-to-back fn()
    (after one warm-up), per call.  A kernel is timed over many calls so
    that the stream never waits for the host between launches."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one fn(): `calls` calls captured in one CUDA graph,
    the replays timed with CUDA events (median of `reps` after a warm-up
    replay), per call.  For kernels that run shorter than the Python that
    launches them, where cuda_ms would time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # builds, allocator pools
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


# H100 SXM: HBM3 rate from the data sheet; INT32 issue as 132 SMs x 64
# lanes x 1.98 GHz boost (half of the 67 TFLOP/s float32 lanes, one
# operation each), since the data sheet gives no integer rate
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
GOTOH_OPS_PER_CELL = 45  # warp kernel's arithmetic: M 12, I 12, D + both scans 13, fields/pack/store 8
SHEAR_OPS_PER_BYTE = 11  # decode 1, range 1, count 1, allele 5, strand column 2, count 1


def bound(n_bytes: int, n_ops: int):
    """(bound_ms, bound_by) of a kernel that must move n_bytes and do
    n_ops integer operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gotoh_bound(B: int, Lq: int, Ls: int):
    """Inputs int8 (B,Lq), (B,Ls) and two int32 (B,); outputs the int32
    (Lq,B,Ls) plane and four int32 (B,); every cell computed (rows past
    qlen still get fresh D-run fields)."""
    n_bytes = B * (Lq + Ls) + 8 * B + 4 * Lq * B * Ls + 16 * B
    return bound(n_bytes, GOTOH_OPS_PER_CELL * B * Lq * Ls)


SM_CLOCK_HZ = 1.98e9

# Latency microbenchmark of the links a Viterbi step chains: one warp runs
# reps x 128 dependent links of one kind between two clock64() reads (the last
# link's value is stored to shared memory before the second read, so the
# chain cannot move past it); the cycles of an empty loop are taken off.
VITERBI_LATENCY_CU = r"""
#include <cuda_runtime.h>

namespace {
constexpr int kUnroll = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long stamp() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// kind 0: empty loop; 1: DADD; 2: f64 fmax; 3: compare-select of a
// double (v > x ? v : x); 4: the same carrying an int index beside it;
// 5: f64 __shfl_sync; 6: st.shared, __syncwarp, ld.shared of another
// lane's double (two buffers by parity, as a step's exchange would)
template <int kKind>
__global__ void __launch_bounds__(32) chain_kernel(const double* __restrict__ in, int reps,
                                                   long long* cycles, double* sink) {
  __shared__ double s[64];
  __shared__ double done[32];
  const int lane = threadIdx.x;
  double y[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) y[k] = in[k];
  double x = in[8 + lane];
  int a = 0;
  const int src = (lane + 1) & 31;
  __syncwarp();
  const long long t0 = stamp();
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const double v = y[k & 7];
      if (kKind == 1) {
        x = x + v;
      } else if (kKind == 2) {
        x = fmax(x, v);
      } else if (kKind == 3) {
        x = v > x ? v : x;
      } else if (kKind == 4) {
        const bool up = v > x;
        x = up ? v : x;
        a = up ? k : a;
      } else if (kKind == 5) {
        x = __shfl_sync(kFull, x, src);
      } else if (kKind == 6) {
        s[(k & 1) * 32 + lane] = x;
        __syncwarp();
        x = s[(k & 1) * 32 + src];
      }
    }
  }
  done[lane] = x + a;
  const long long t1 = stamp();
  if (lane == 0) cycles[kKind] = t1 - t0;
  sink[kKind * 32 + lane] = done[src];
}
}  // namespace

extern "C" int viterbi_latency(const void* in, int reps, void* cycles, void* sink) {
  long long* c = (long long*)cycles;
  double* s = (double*)sink;
  const double* i = (const double*)in;
  chain_kernel<0><<<1, 32>>>(i, reps, c, s);
  chain_kernel<1><<<1, 32>>>(i, reps, c, s);
  chain_kernel<2><<<1, 32>>>(i, reps, c, s);
  chain_kernel<3><<<1, 32>>>(i, reps, c, s);
  chain_kernel<4><<<1, 32>>>(i, reps, c, s);
  chain_kernel<5><<<1, 32>>>(i, reps, c, s);
  chain_kernel<6><<<1, 32>>>(i, reps, c, s);
  return (int)cudaGetLastError();
}
"""
VITERBI_LATENCY_KINDS = ("dadd", "fmax", "select", "select_int", "shfl", "smem")


def _sass_ops(so_path: str) -> dict:
    """SASS opcodes of each chain_kernel<kind> in the library (cuobjdump
    -sass, where the toolkit has it): {kind: Counter of opcodes}."""
    from ngsepcore_tpu_torch.kernels import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                         timeout=120).stdout
    ops, kind = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : \S*chain_kernelILi(\d)E", line)
        if m:
            kind = int(m.group(1))
            ops[kind] = Counter()
        elif kind is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                ops[kind][m.group(1).split(".")[0]] += 1
    return ops


def viterbi_latencies(reps: int = 64) -> dict:
    """Cycles a link of each chain kind (VITERBI_LATENCY_KINDS) on this
    card, measured by VITERBI_LATENCY_CU (built into the package's build
    directory), and the SASS opcodes of the f64 max and compare-select
    chains ("fmax_ops", "select_ops")."""
    import ctypes

    import torch

    from ngsepcore_tpu_torch.kernels import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / "viterbi_latency.cu"
    src.write_text(VITERBI_LATENCY_CU)
    lib, info = cuda_build.build([src], stem="libviterbi_latency")
    fn = lib.viterbi_latency
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    inp = torch.from_numpy(np.random.default_rng(0).random(40)).cuda()
    cycles = torch.zeros(7, dtype=torch.int64, device="cuda")
    sink = torch.empty(7 * 32, dtype=torch.float64, device="cuda")
    links = reps * 128
    best = None
    for _ in range(5):  # the least of 5 runs: the chains own the SM alone
        cuda_build.check("viterbi_latency", fn(inp.data_ptr(), reps, cycles.data_ptr(),
                                               sink.data_ptr()))
        torch.cuda.synchronize()
        c = cycles.cpu().numpy()
        best = c if best is None else np.minimum(best, c)
    out = {k: float(best[i + 1] - best[0]) / links for i, k in enumerate(VITERBI_LATENCY_KINDS)}
    ops = _sass_ops(info["path"])
    out["fmax_ops"] = dict(ops.get(2, {}))
    out["select_ops"] = dict(ops.get(3, {}))
    return out


def viterbi_chain_cycles(lat: dict, S: int) -> float:
    """Cycles of the shortest exact step's chain (csrc/viterbi.cu): the
    exchange that brings every lane the previous deltas (the shorter of a
    shuffle and a shared-memory round trip; none for one state), the add
    of the transition, ceil(log2 S) levels of a compare-select (the first
    maximum, exact to the sign of a zero; f64 fmax takes longer), the add
    of the emission."""
    levels = int(np.ceil(np.log2(S))) if S > 1 else 0
    exchange = min(lat["shfl"], lat["smem"]) if S > 1 else 0.0
    return exchange + lat["dadd"] + levels * lat["select"] + lat["dadd"]


def viterbi_bound(T: int, S: int, chain_cycles: float):
    """(bound_ms, bound_by, bytes ms, chain ms): emissions f64 read and int8
    back pointers written once (T*S*9 bytes), the int32 path (4*T); the
    serial chain of T steps at `chain_cycles` a step (viterbi_chain_cycles
    of this card's measured latencies)."""
    t_bytes = (T * S * 9 + 4 * T) / HBM_BYTES_PER_S * 1e3
    t_chain = T * chain_cycles / SM_CLOCK_HZ * 1e3
    ms, by = (t_bytes, "bytes") if t_bytes >= t_chain else (t_chain, "operations")
    return ms, by, t_bytes, t_chain


# the run-jump walk (csrc/run_walk.cu) is a chain of dependent loads: each
# step's address comes from the word the step before loaded.  A load that
# hits the L2 (the Gotoh kernel has just written the plane) is taken as 260
# cycles at the boost clock, the order that pointer-chase microbenchmarks of
# Hopper report (Luo et al., "Benchmarking and Dissecting the Nvidia Hopper
# GPU Architecture", 2024); phase 2c prints the kernel's own step time on a
# lone chain beside it
L2_HIT_CYCLES = 260


def walk_bound(B: int, R: int, loads, mode: str = "runs", code_reads: int = 0):
    """(bound_ms, bound_by) of the walk kernel in `mode` over B alignments
    with budget R.  Bytes: the plane words the walk reads (`loads`, per
    row, from walk_loads) and, by mode, "runs": three (B,) int32 inputs,
    the (B, R) int32 rop and rlen and four (B,) outputs (13 bytes a row);
    "tier3": four (B,) int32 inputs (score too), the codes that the
    left-alignment's backward compare reads (`code_reads`, from
    walk_code_reads), the (B, R) int16 rle and six (B,) outputs (18 bytes
    a row); "hamming": four (B,) int32 inputs, the rle and four (B,)
    outputs (13 bytes a row).  The chain is the longest row's loads at one
    L2 hit each ("operations": dependent instructions, as for the
    Viterbi)."""
    n_loads = int(loads.sum())
    n_bytes = 4 * n_loads + {
        "runs": 12 * B + 8 * B * R + 13 * B,
        "tier3": 16 * B + code_reads + 2 * B * R + 18 * B,
        "hamming": 16 * B + 2 * B * R + 13 * B,
    }[mode]
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_chain = int(loads.max(initial=0)) * L2_HIT_CYCLES / SM_CLOCK_HZ * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_chain else (t_chain, "operations")


def walk_code_reads(runs, query, subject) -> int:
    """Query and subject codes that the tier-3 epilogue's backward compare
    reads over the merged runs `runs` (the runs mode's output for the same
    walk), as csrc/run_walk.cu's pass over the slots takes them: for a gap
    run of length l (1..LA_LMAX) after an M run, the compare of the codes
    at u and u + l from u = pos down, until a pair differs, min(lens[t-1],
    p) pairs are equal, or u leaves the row; c compares read c + min(c, l)
    distinct codes.  The data-dependent bytes of the tier-3 mode."""
    la_lmax = 16  # kernels/pairwise.LA_LMAX
    rop, rlen = runs["rop"].tolist(), runs["rlen"].tolist()
    n_runs, start_j = runs["n_runs"].tolist(), runs["start_j"].tolist()
    qs, ss = query.tolist(), subject.tolist()
    Lq, Ls = query.shape[1], subject.shape[1]
    total = 0
    for b, n in enumerate(n_runs):
        ops, lens = rop[b], rlen[b]
        pq, ps, prev_op, prev_len, carry = 0, start_j[b], 0, 0, 0
        for t in range(n):
            op, ln = ops[t], lens[t]
            k = 0
            if t >= 1:
                if op in (2, 3) and prev_op == 1 and 1 <= ln <= la_lmax:
                    x, L, p = (qs[b], Lq, pq) if op == 2 else (ss[b], Ls, ps)
                    u, cap, c = min(max(p - 1, 0), L - 1), min(prev_len, p), 0
                    while k < cap and u >= 0 and u + ln < L:
                        c += 1
                        if x[u] != x[u + ln]:
                            break
                        k += 1
                        u -= 1
                    total += c + min(c, ln)
                if not (t + 1 < n and ops[t + 1] == 1):
                    k = 0
                prev_len -= k
            pq += ln if op in (1, 2) else 0
            ps += ln if op in (1, 3) else 0
            prev_op, prev_len, carry = op, ln + carry, k
    return total


def walk_loads(plane, end_i, end_j, start_k, R):
    """Plane words each row's walk reads (its steps inside the alignment,
    at most R): the data-dependent work of the walk, counted on the
    tensors' device."""
    import torch

    B = plane.shape[1]
    bb = torch.arange(B, device=plane.device)
    i, j, k = end_i.long(), end_j.long(), start_k.long()
    loads = torch.zeros(B, dtype=torch.int64, device=plane.device)
    for _ in range(R):
        live = (i > 0) & (j > 0)
        w = plane[(i - 1).clamp(min=0), bb, (j - 1).clamp(min=0)].long() & 0xFFFFFFFF
        run = (w >> (8 * k + 8)) & 255
        r = torch.where(run == 255, 254, run)
        i = torch.where(live & (k <= 1), i - r, i)
        j = torch.where(live & (k != 1), j - r, j)
        k = torch.where(live & (run != 255), (w >> (2 * k)) & 3, k)
        loads += live
    return loads.cpu().numpy()


def reset_counts(counters) -> None:
    """Set every kernel's launch count to 0."""
    for c in counters:
        c.launches = 0
        if hasattr(c, "launch_shapes"):
            c.launch_shapes.clear()


def tier2_shapes(gotoh) -> dict:
    """Gotoh launches with a free query end since the last reset_counts:
    {flank side: Counter of (B, Lq, Ls, "warp", "seg" or "wide")}."""
    key = lambda cfg: tuple(bool(cfg.get(f, d)) for f, d in (
        ("free_start1", False), ("free_end1", False),
        ("free_start2", True), ("free_end2", True)))
    sides = {key(TIER2_LEFT): "left", key(TIER2_RIGHT): "right"}
    out = {"left": Counter(), "right": Counter()}
    for (ends, *shape), n in gotoh.launch_shapes.items():
        if ends in sides:
            out[sides[ends]][tuple(shape)] += n
    return out


def tier2_launches(shapes: dict) -> dict:
    return {side: sum(by.values()) for side, by in shapes.items()}


def tier2_walk_launches(walk) -> dict:
    """Walk launches of the tier-2 flanks since the last reset_counts, from
    the walk's own counter: {flank side: n}.  Tier 2 walks in the "runs"
    mode with the budget R = Lq + Ls (tier 3 and long reads take the
    "tier3" and "hamming" modes); the left flank's subject start is free,
    the right flank's is not."""
    out = {"left": 0, "right": 0}
    for (mode, B, Lq, Ls, R, free_start2), n in walk.launch_shapes.items():
        if mode == "runs" and R == Lq + Ls:
            out["left" if free_start2 else "right"] += n
    return out


def walk_route(counters, mode: str, where: str) -> None:
    """Fail unless every walk launch since the last reset_counts took
    `mode` and there is one a Gotoh launch (counters: gotoh, walk, ...)."""
    gotoh, walk = counters[0], counters[1]
    modes = Counter()
    for key, n in walk.launch_shapes.items():
        modes[key[0]] += n
    if set(modes) != {mode} or walk.launches != gotoh.launches:
        fail(f"{where}: walk launches by mode {dict(modes)} for {gotoh.launches} Gotoh "
             f"launches; every one should take the {mode} mode")


class plain_post_pass_forbidden:
    """Within it (on `device` "cuda") the plain walk and post-passes raise:
    a CUDA route that reaches them fails instead of falling back."""

    NAMES = ("_runs_from_plane_ref", "dp_stats_runs", "_left_align_rle",
             "dp_stats_runs_hamming")

    def __init__(self, device="cuda"):
        self.names = self.NAMES if device == "cuda" else ()

    def __enter__(self):
        from ngsepcore_tpu_torch.kernels import pairwise

        def trip(name):
            def f(*args, **kwargs):
                raise RuntimeError(f"the CUDA route ran the plain {name}")
            return f

        self.saved = {n: getattr(pairwise, n) for n in self.names}
        for n in self.names:
            setattr(pairwise, n, trip(n))
        return self

    def __exit__(self, *exc):
        from ngsepcore_tpu_torch.kernels import pairwise

        for n, f in self.saved.items():
            setattr(pairwise, n, f)
        return False


def shapes_text(by: Counter) -> str:
    """'n x BxLqxLs kernel' for every launched shape, widest subject last."""
    return ", ".join(
        f"{n} x {B}x{Lq}x{Ls} {kern}"
        for (B, Lq, Ls, kern), n in sorted(by.items(), key=lambda kv: kv[0][2])
    ) or "none"


def false_snvs(records, truth_snv, arrays, near: int = 150):
    """Positions of the SNV calls that bench.check_accuracy counts against
    the precision, and how many lie within `near` bp of a tandem array
    (0-based half-open (start, end))."""
    called = {(r.variant.first, r.variant.alleles[1]) for r in records
              if r.variant.is_snv and len(r.variant.alleles) > 1}
    pos = np.array(sorted(p for p, _ in called - truth_snv), np.int64)
    lo = np.array([a for a, _ in arrays], np.int64) + 1 - near
    hi = np.array([b for _, b in arrays], np.int64) + near
    at = (pos[:, None] >= lo[None, :]) & (pos[:, None] <= hi[None, :])
    return pos, int(at.any(axis=1).sum())


# ---------------------------------------------------------------------------
def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = nvidia_smi()
    print(smi, flush=True)
    # the genotyper's float32 screen must run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"phase 0 device: {torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build():
    from ngsepcore_tpu_torch.kernels import cuda_build

    t0 = time.perf_counter()
    cuda_build.library()
    log(f"phase 1 build: {time.perf_counter() - t0:.2f}s -> "
        f"{cuda_build.build_info['path']}")
    name = ""
    for line in cuda_build.build_info["ptxas"].splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:  # the kernel's name and its template arguments, still mangled
            k = re.search(r"([A-Za-z_]+_kernel)((?:I|L[a-z]-?\d+E)*)", m.group(1))
            name = "".join(k.groups()) if k else m.group(1)[:48]
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {name}:", line.strip(), flush=True)


# ---------------------------------------------------------------------------
def _bench_chunk(rng, B, Lq, Ls):
    """Read-like tier-3 jobs (the generator of bench.measure_dp_cell_rate):
    the query embedded at column 40 with 2% substitutions."""
    q = rng.integers(0, 4, (B, Lq), dtype=np.int8)
    s = rng.integers(0, 4, (B, Ls), dtype=np.int8)
    w = min(Lq, Ls - 40)
    s[:, 40 : 40 + w] = np.where(
        rng.random((B, w)) < 0.02, rng.integers(0, 4, (B, w), dtype=np.int8), q[:, :w]
    )
    ql = np.full(B, min(150, Lq), np.int32)
    sl = np.full(B, min(250, Ls), np.int32)
    return q, ql, s, sl


def _noisy(rng, B, Lq, Ls):
    """tests/test_pairwise_pallas.py's generator: queries with a few indels
    embedded in random subjects, ragged qlen/slen."""
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    s = rng.integers(0, 4, (B, Ls)).astype(np.int8)
    for b in range(B):
        off = int(rng.integers(0, max(1, Ls - Lq - 5)))
        piece = list(q[b][: Lq - 6])
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(1, len(piece) - 1))
            if rng.random() < 0.5:
                piece.insert(p, int(rng.integers(0, 4)))
            else:
                del piece[p]
        piece = np.array(piece[: Ls - off], np.int8)
        s[b, off : off + len(piece)] = piece
    ql = rng.integers(Lq // 2, Lq + 1, B).astype(np.int32)
    sl = rng.integers(int(Ls * 0.8), Ls + 1, B).astype(np.int32)
    return q, ql, s, sl


def _classic_chunk(rng, B, read_len=150, Lq=192, Ls=192):
    """Classic tier-3 jobs (ReadsAligner._tier3_dispatch): the read's
    subject window starts 3 bases before its predicted start and is
    read_len + 6 wide, query and subject padded with N to 64-granular
    widths; 2% substitutions."""
    q = np.full((B, Lq), 4, np.int8)
    s = np.full((B, Ls), 4, np.int8)
    win = rng.integers(0, 4, (B, read_len + 6), dtype=np.int8)
    s[:, : read_len + 6] = win
    q[:, :read_len] = np.where(
        rng.random((B, read_len)) < 0.02,
        rng.integers(0, 4, (B, read_len), dtype=np.int8),
        win[:, 3 : 3 + read_len],
    )
    return (q, np.full(B, read_len, np.int32), s,
            np.full(B, read_len + 6, np.int32))


def _tier2_chunk(rng, B, side, Lq=160, Ls=224, read_len=150):
    """Tier-2 STR flank jobs (align/str_tier2.Tier2STRAligner._run_flank):
    a left flank's read segment matches the END of its reference window and
    runs on into the repeat (free query end, free subject start); a right
    flank's segment comes out of the repeat and matches the START of its
    window.  Ragged lengths, 2% substitutions, N padding."""
    q = np.full((B, Lq), 4, np.int8)
    s = np.full((B, Ls), 4, np.int8)
    read_len = min(read_len, Lq)
    ql = rng.integers(read_len // 2, read_len + 1, B).astype(np.int32)
    sl = rng.integers(Ls // 2, Ls + 1, B).astype(np.int32)
    for b in range(B):
        ref = rng.integers(0, 4, sl[b]).astype(np.int8)
        seg = rng.integers(0, 4, ql[b]).astype(np.int8)
        m = int(min(ql[b], sl[b]))
        n = int(rng.integers(min(20, m // 2), max(m - 5, min(20, m // 2) + 1)))
        flank = ref[sl[b] - n :] if side == "left" else ref[:n]
        flank = np.where(rng.random(n) < 0.02, rng.integers(0, 4, n), flank)
        if side == "left":
            seg[:n] = flank
        else:
            seg[ql[b] - n :] = flank
        q[b, : ql[b]] = seg
        s[b, : sl[b]] = ref
    return q, ql, s, sl


def _random_jobs(rng, B, Lq, Ls, alphabet=5):
    """Unrelated query/subject codes (N included) with ragged lengths."""
    q = rng.integers(0, alphabet, (B, Lq)).astype(np.int8)
    s = rng.integers(0, alphabet, (B, Ls)).astype(np.int8)
    w = min(Lq, Ls)
    s[:, :w] = np.where(rng.random((B, w)) < 0.2, s[:, :w], q[:, :w])
    ql = rng.integers(0, Lq + 1, B).astype(np.int32)
    sl = rng.integers(0, Ls + 1, B).astype(np.int32)
    ql[0], sl[0] = Lq, Ls
    return q, ql, s, sl


def _saturating(rng, B, Lq, Ls):
    """Identical and all-N rows whose M and I runs outgrow the 8-bit run
    lengths of the plane."""
    q, ql, s, sl = _random_jobs(rng, B, Lq, Ls, alphabet=4)
    q[0], s[0] = 1, 1
    q[1] = 4
    ql[:2] = Lq
    sl[:2] = Ls
    return q, ql, s, sl


def _edge_cases(rng):
    """Shapes that are edges of the Gotoh kernels' layouts: (name, inputs).
    The warp-per-alignment kernel takes Ls <= 256 with ceil(Ls/32) columns
    a lane and four alignments a block; wider subjects take the seg kernel
    (seg_layout: W = ceil(Ls/256) warps an alignment, ceil(Ls/224) with
    a free query end, K = ceil(Ls/(32W)) columns a lane)."""
    q0, ql0, s0, sl0 = _noisy(rng, 203, 48, 128)
    ql0[::3] = 0
    sl0[::5] = 0
    qn, qln, sn, sln = _noisy(rng, 64, 48, 160)
    qn[:] = 4
    sn[:] = 4
    return [
        ("Ls 256 (widest register variant), B 301", _noisy(rng, 301, 64, 256)),
        ("Ls 256, runs past 255", _saturating(rng, 30, 300, 256)),
        ("Ls 288 (seg kernel)", _noisy(rng, 130, 64, 288)),
        ("Ls 512 (seg kernel)", _noisy(rng, 67, 96, 512)),
        ("Ls 1024 (seg kernel)", _noisy(rng, 19, 64, 1024)),
        ("Ls 33", _random_jobs(rng, 37, 40, 33)),
        ("Ls 1", _random_jobs(rng, 9, 12, 1)),
        ("Lq 1", _random_jobs(rng, 50, 1, 70)),
        ("B 1", _noisy(rng, 1, 48, 128)),
        ("qlen 0 and slen 0 rows, B 203", (q0, ql0, s0, sl0)),
        ("all-N query and subject", (qn, qln, sn, sln)),
    ]


def _long_read_chunk(rng, B, W, kind):
    """Long-read segment jobs (align/long_reads.LongReadsAligner._chain): a
    reference stretch and the read's copy of it with 1% substitutions and
    1% indels, spans spread over the bucket (1-128 at W 128, 129-512 at W
    512); a start segment's window begins 5 bases early (free subject
    start), an end segment's ends 5 bases late (free subject end).  N
    padding."""
    q = np.full((B, W), 4, np.int8)
    s = np.full((B, W), 4, np.int8)
    ql = np.zeros(B, np.int32)
    sl = np.zeros(B, np.int32)
    lo = 1 if W == 128 else 129
    for b in range(B):
        core = rng.integers(0, 4, int(rng.integers(lo, W + 1))).astype(np.int8)
        read = core.copy()
        sub = rng.random(len(read)) < 0.01
        read[sub] = (read[sub] + 1) % 4
        for p in np.nonzero(rng.random(len(core)) < 0.01)[0][::-1]:
            read = (np.delete(read, p) if rng.random() < 0.5
                    else np.insert(read, p, rng.integers(0, 4)))
        extra = rng.integers(0, 4, 5).astype(np.int8)
        ref = {"start": np.concatenate([extra, core]),
               "end": np.concatenate([core, extra])}.get(kind, core)
        read, ref = read[:W], ref[:W]
        q[b, : len(read)], s[b, : len(ref)] = read, ref
        ql[b], sl[b] = len(read), len(ref)
    return q, ql, s, sl


def _skip_seventh(rng, B, W):
    """Queries that skip one subject base in every seven: a deletion run
    every six matches, more runs than the tier-3 walk budget allows."""
    s = rng.integers(0, 4, (B, W)).astype(np.int8)
    q = np.full((B, W), 4, np.int8)
    kept = s[:, np.arange(W) % 7 != 6]
    q[:, : kept.shape[1]] = kept
    return q, np.full(B, kept.shape[1], np.int32), s, np.full(B, W, np.int32)


# phase 2's timed shapes of a flank over a ~1,500 bp STR (phase 9's long
# array; the seg kernel since the wide kernel's range starts above it)
STR1500_TIMED = {side: f"tier-2 {side} flank 256x160x1664"
                 for side in ("left", "right")}
TIER2_LEFT = dict(free_end1=True, free_start2=True, free_end2=False)
TIER2_RIGHT = dict(free_start1=True, free_start2=False, free_end2=True)
# the long-read segment kinds' free subject ends (long_reads._run_dp_jobs)
LONG_READ_CFGS = {
    "center": dict(free_start2=False, free_end2=False),
    "start": dict(free_start2=True, free_end2=False),
    "end": dict(free_start2=False, free_end2=True),
}
_GOTOH_CFGS = (
    dict(free_start2=True, free_end2=True),
    dict(free_start2=False, free_end2=False),
    dict(free_start2=True, free_end2=False),
    TIER2_LEFT,
    TIER2_RIGHT,
)


def _gotoh_mismatches(got, ref):
    """(cells of the FULL plane that differ, [score, end_i, end_j,
    start_k] mismatches, max abs error over all of them)."""
    full = int((got[0] != ref[0]).sum())
    vec_bad = [int((a != b).sum()) for a, b in zip(got[1:], ref[1:])]
    err = max(
        [int((got[0].long() - ref[0].long()).abs().max())]
        + [int((a.long() - b.long()).abs().max()) for a, b in zip(got[1:], ref[1:])]
    )
    return full, vec_bad, err


def _cluster_cases(rng):
    """The cluster kernel's cases (name, inputs, configurations): by shape
    at its widths, B 5 and Lq 64 with qlen-0 rows, slen 0 and N runs, in
    the four free-end configurations the paths use; runs past 255; a batch
    whose clusters do not all fit one wave.  Every case also runs the
    cluster kernel forced (two blocks a cluster or more) and the wide
    kernel forced."""
    from ngsepcore_tpu_torch.kernels.pairwise_cuda import CLUSTER_MAX_LS

    cfgs = (LONG_READ_CFGS["center"], TIER2_LEFT, TIER2_RIGHT, _GOTOH_CFGS[0])
    out = []
    for Ls in (3585, 4096, 5000, 8192, 16384, CLUSTER_MAX_LS):
        q, ql, s, sl = _noisy(rng, 5, 64, Ls)
        ql[0] = 0
        sl[1] = 0
        q[2, 32:] = 4
        s[2, Ls // 2 :] = 4
        out += [(f"cluster Ls {Ls}, B 5, qlen 0, slen 0, N runs", (q, ql, s, sl), cfgs)]
    out.append(("cluster Ls 4096, runs past 255", _saturating(rng, 5, 300, 4096), ({},)))
    out.append((f"cluster Ls {CLUSTER_MAX_LS}, runs past 255",
                _saturating(rng, 3, 260, CLUSTER_MAX_LS), ({},)))
    q, ql, s, sl = _noisy(rng, 300, 32, 4096)
    ql[::7] = 0
    out.append(("cluster Ls 4096, B 300 (more than one wave)", (q, ql, s, sl),
                (_GOTOH_CFGS[0], TIER2_LEFT)))
    # the forced cluster kernel at the seg kernel's widths
    for Ls in (257, 1664, 3584):
        q, ql, s, sl = _noisy(rng, 37, 64, Ls)
        ql[::5] = 0
        sl[1] = 0
        out.append((f"cluster forced, Ls {Ls}, B 37", (q, ql, s, sl), cfgs))
    return out


def phase_gotoh():
    """The four Gotoh kernels against the plain version, bit for bit on
    the full plane; times of the kernel the wrapper picks and of the plain
    version at the shapes the main paths use.  The seg kernel is also held
    at every narrower case (one warp, 4-8 columns a lane), the cluster
    kernel (forced, two blocks a cluster or more) at every case of more
    than 256 columns, and the wide kernel at every case it does not take
    by shape."""
    import torch

    from ngsepcore_tpu_torch.kernels.pairwise_cuda import (
        CLUSTER_MAX_LS,
        device_cluster_layout,
        gotoh_forward_plane,
        gotoh_forward_plane_cluster,
        gotoh_forward_plane_ref,
        gotoh_forward_plane_seg,
        gotoh_forward_plane_wide,
        kernel_for,
        seg_layout,
    )

    rng = np.random.default_rng(0)
    timed = [
        ("bench chunk 2048x160x256", _bench_chunk(rng, 2048, 160, 256)),
        ("main-path chunk 2048x160x160", _bench_chunk(rng, 2048, 160, 160)),
        ("classic tier-3 2048x192x192", _classic_chunk(rng, 2048)),
        ("classic tier-3 256x192x192", _classic_chunk(rng, 256)),
    ]
    cases = [(n, d, {}) for n, d in timed]
    timed_t2 = [
        ("tier-2 left flank 256x160x224", _tier2_chunk(rng, 256, "left"), TIER2_LEFT),
        ("tier-2 right flank 256x160x224", _tier2_chunk(rng, 256, "right"), TIER2_RIGHT),
        # phase 10's top shapes (the known-STR run at 4.6 Mbp)
        ("tier-2 left flank 256x160x384", _tier2_chunk(rng, 256, "left", Ls=384),
         TIER2_LEFT),
        ("tier-2 right flank 256x160x352", _tier2_chunk(rng, 256, "right", Ls=352),
         TIER2_RIGHT),
        # a flank window over a known STR of ~1,500 bp (phase 9's long array)
        (STR1500_TIMED["left"], _tier2_chunk(rng, 256, "left", Ls=1664), TIER2_LEFT),
        (STR1500_TIMED["right"], _tier2_chunk(rng, 256, "right", Ls=1664), TIER2_RIGHT),
    ]
    cases += timed_t2
    timed_lr = [
        (f"long reads {kind} 512x{W}x{W}", _long_read_chunk(rng, 512, W, kind), cfg)
        for W in (128, 512) for kind, cfg in LONG_READ_CFGS.items()
    ]
    cases += timed_lr
    cases.append(("ragged 1000x160x200", _noisy(rng, 1000, 160, 200), {}))
    for cfg in _GOTOH_CFGS:
        cases.append((f"pallas-test 256x48x128 {cfg}", _noisy(rng, 256, 48, 128), cfg))
    for name, data in _edge_cases(rng):
        for cfg in _GOTOH_CFGS:
            cases.append((f"{name} {cfg}", data, cfg))
    # the seg kernel's widths up to SEG_MAX_LS, then the cluster kernel's
    for Ls in (1025, 1536, 2048, 3584, 4096, 8192):
        q, ql, s, sl = _noisy(rng, 37, 160, Ls)
        ql[::5] = 0
        sl[1] = 0
        for cfg in (LONG_READ_CFGS["center"], TIER2_LEFT, TIER2_RIGHT, _GOTOH_CFGS[0]):
            cases.append((f"Ls {Ls} ({kernel_for(Ls)}), B 37, qlen 0 rows {cfg}",
                          (q, ql, s, sl), cfg))
    qn, qln, sn, sln = _noisy(rng, 40, 96, 700)
    qn[:] = 4
    sn[:] = 4
    for cfg in _GOTOH_CFGS:
        cases.append((f"seg Ls 600, B 1 {cfg}", _noisy(rng, 1, 160, 600), cfg))
        cases.append((f"seg Ls 700, all-N query and subject {cfg}", (qn, qln, sn, sln), cfg))
    cases.append(("seg Ls 300, runs past 255", _saturating(rng, 30, 300, 300), {}))
    cases.append(("seg Ls 2100, runs past 255", _saturating(rng, 9, 300, 2100), {}))
    cases.append(("Ls 5000, runs past 255", _saturating(rng, 5, 300, 5000), {}))
    for name, data, cfgs in _cluster_cases(rng):
        cases += [(f"{name} {cfg}", data, cfg) for cfg in cfgs]
    # the wide kernel by shape just past the cluster kernel's widest
    cases.append((f"wide Ls {CLUSTER_MAX_LS + 1}, B 3",
                  _noisy(rng, 3, 24, CLUSTER_MAX_LS + 1), {}))
    timed_names = {n for n, _ in timed} | {n for n, _, _ in timed_t2 + timed_lr}
    timing = {}
    n_cells = 0
    for name, (q, ql, s, sl), cfg in cases:
        args = [torch.from_numpy(a).cuda() for a in (q, ql, s, sl)]
        ref = gotoh_forward_plane_ref(*args, **cfg)
        Ls = s.shape[1]
        kernels = [("kernel", gotoh_forward_plane)]
        if Ls <= 256:  # wider subjects take the seg kernel anyway
            kernels.append(("seg kernel", gotoh_forward_plane_seg))
        if Ls > 256:  # two blocks a cluster or more, at every width
            kernels.append(("cluster kernel", gotoh_forward_plane_cluster))
        if Ls <= CLUSTER_MAX_LS:  # wider subjects take the wide kernel anyway
            kernels.append(("wide kernel", gotoh_forward_plane_wide))
        err = 0
        for label, fn in kernels:
            got = fn(*args, **cfg)
            torch.cuda.synchronize()
            full, vec_bad, label_err = _gotoh_mismatches(got, ref)
            err = max(err, label_err)
            log(f"phase 2 gotoh {name}, {label}: full-plane mismatches {full} "
                f"of {got[0].numel()}, score/end_i/end_j/start_k mismatches {vec_bad}")
            if full or any(vec_bad):
                fail(f"gotoh {label} disagrees with its plain version on {name}")
            n_cells += got[0].numel()
            del got
        if name in timed_names:
            B, Lq = q.shape
            kern = kernel_for(Ls)
            if kern == "seg":
                kern_text = "seg, K {}, W {}".format(
                    *seg_layout(Ls, cfg.get("free_end1", False)))
            elif kern == "cluster":
                kern_text = "cluster, N {}, W {}, K {}".format(*device_cluster_layout(
                    B, Ls, cfg.get("free_start1", False), cfg.get("free_end1", False)))
            else:
                kern_text = kern
            ms = cuda_ms(lambda: gotoh_forward_plane(*args, **cfg), calls=20)
            g_ms = graph_ms(lambda: gotoh_forward_plane(*args, **cfg))
            plain = cuda_ms(lambda: gotoh_forward_plane_ref(*args, **cfg), reps=3)
            b_ms, b_by = gotoh_bound(B, Lq, Ls)
            log(f"  time {name}: kernel ({kern_text}) {ms:.4f} ms (median of 5 x 20 "
                f"calls), {g_ms:.4f} ms in a CUDA graph of 20 calls, plain {plain:.3f} ms "
                f"(median of 3); bound {b_ms:.4f} ms by {b_by}, kernel at "
                f"{100 * b_ms / ms:.1f}% of it ({100 * b_ms / g_ms:.1f}% in the graph)")
            timing[name] = dict(ms=ms, plain_ms=plain, max_abs_err=err, graph_ms=g_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                shape=f"{B}x{Lq}x{Ls}", kernel=kern)
        del ref
    log(f"phase 2 gotoh: {len(cases)} cases, {n_cells} plane cells compared, "
        "0 differing")
    timing["cluster occupancy"] = cluster_occupancy_report()
    return timing


def cluster_occupancy_report():
    """cudaOccupancyMaxActiveClusters of the cluster kernel at the MSA's
    69x3936x3936 layouts (every N, free subject ends) beside the SM
    arithmetic (16 // W blocks an SM of 128 registers a thread), which GPC
    boundaries can make larger; the layout rule takes the card's."""
    import torch

    from ngsepcore_tpu_torch.kernels.pairwise_cuda import (
        cluster_occupancy,
        cluster_shape,
        device_cluster_layout,
    )

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rule = device_cluster_layout(69, 3936)
    out = {}
    for n in range(1, 9):
        W, K = cluster_shape(3936, False, n)
        held = cluster_occupancy(n, W, K)
        arithmetic = n_sms * (16 // W) // n
        out[f"N {n}, W {W}, K {K}"] = dict(clusters=held, sm_arithmetic=arithmetic)
        log(f"phase 2 cluster kernel at 3936 columns, N {n}, W {W}, K {K}: the card holds "
            f"{held} clusters at once (cudaOccupancyMaxActiveClusters), the SM arithmetic "
            f"{arithmetic}; 69 alignments {'fit' if held >= 69 else 'do not fit'} one "
            f"wave{' (the rule picks this layout)' if rule == (n, W, K) else ''}")
    return out


def _wide_plane(rng, B, Lq, Ls):
    """A plane of random words with pointer fields 0..2 and run lengths
    1..255 (saturated ones included), built slab by slab on the card: more
    than 2^31 cells at B 2048 x Lq 1100 x Ls 1024, so that a 32-bit offset
    would read the wrong word."""
    import torch

    plane = torch.empty((Lq, B, Ls), dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 31)))
    for i in range(Lq):
        f = lambda hi: torch.randint(0, hi, (3, B, Ls), dtype=torch.int32,
                                     device="cuda", generator=gen)
        src, run = f(3), f(255) + 1
        run[2] &= 127  # the top field stays below the sign bit
        plane[i] = (src[0] | (src[1] << 2) | (src[2] << 4) | (run[0] << 8)
                    | (run[1] << 16) | (run[2] << 24))
    return plane


def _runs_plane(rng, B, Lq, Ls, free_start2):
    """Synthetic walk inputs for the left-alignment's edges: random forward
    runs per row (M runs of 1-12 between gaps of 1-20 columns, some of
    17-30, an I and a D back to back, gaps at either end) put in a plane
    that the walk turns into them (`pairwise.plane_from_runs`), over
    codes of a two-letter alphabet with N stretches, N padded.  Returns
    (plane, score, end_i, end_j, start_k, query, subject) on the card."""
    import torch

    from ngsepcore_tpu_torch.kernels.pairwise import plane_from_runs

    rows = []
    q = rng.integers(0, 2, (B, Lq)).astype(np.int8)
    s = rng.integers(0, 2, (B, Ls)).astype(np.int8)
    for b in range(B):
        runs, sj = [], int(rng.integers(0, 6))
        ni = nj = 0
        if rng.random() < 0.25:
            runs.append((1 + int(rng.integers(1, 3)) if not free_start2 else 2,
                         int(rng.integers(1, 6))))
        while True:
            runs.append((1, int(rng.integers(1, 13))))
            u = rng.random()
            gaps = [2 + int(rng.integers(0, 2))] if u < 0.8 else [2, 3] if u < 0.9 else []
            for op in gaps:
                ln = int(rng.integers(17, 31)) if rng.random() < 0.08 else int(rng.integers(1, 5))
                runs.append((op, ln))
            ni = sum(ln for op, ln in runs if op in (1, 2))
            nj = sj + sum(ln for op, ln in runs if op in (1, 3))
            if ni > Lq - 80 or nj > Ls - 80 or rng.random() < 0.1:
                break
        if rng.random() < 0.7 and runs[-1][0] != 1:
            runs.append((1, int(rng.integers(1, 13))))
        ni = sum(ln for op, ln in runs if op in (1, 2))
        nj = sj + sum(ln for op, ln in runs if op in (1, 3))
        rows.append((runs, sj))
        if rng.random() < 0.2:  # an N stretch, and Ns to the end of the row
            a = int(rng.integers(0, max(1, ni - 8)))
            q[b, a : a + 8] = 4
            q[b, ni - 3 :] = 4
        q[b, ni:] = 4
        s[b, nj:] = 4
    plane, end_i, end_j, start_k = plane_from_runs(rows, Lq, Ls)
    score = torch.from_numpy(rng.integers(-80, 80, B).astype(np.int32))
    return tuple(x.cuda() for x in (plane, score, end_i, end_j, start_k,
                                    torch.from_numpy(q), torch.from_numpy(s)))


WALK_MODES = ("runs", "tier3", "hamming")


def _walk_fns(wargs, q, s):
    """{mode: the wrapper call} and {mode: the plain post-pass on walk
    output} for one set of walk arguments."""
    from ngsepcore_tpu_torch.kernels import pairwise

    fs2 = wargs[7]
    kernel = {
        "runs": lambda: pairwise._runs_from_plane(*wargs),
        "tier3": lambda: pairwise.tier3_walk_stats(*wargs[:7], q, s, free_start2=fs2),
        "hamming": lambda: pairwise.segment_walk_stats(*wargs),
    }
    post = {
        "runs": lambda out: out,
        "tier3": lambda out: pairwise.dp_stats_runs(out, q, s),
        "hamming": pairwise.dp_stats_runs_hamming,
    }
    return kernel, post


def phase_walk():
    """The run-jump walk kernel (csrc/run_walk.cu) in its three modes
    against the plain composites on the card: "runs" against the plain
    walk, "tier3" against the plain walk then dp_stats_runs, "hamming"
    against the plain walk then dp_stats_runs_hamming; every output equal,
    on planes from the Gotoh kernel at the shapes of phase 2 and of the
    main paths, and on synthetic planes for the left-alignment's edges.
    The shapes that the main paths launch are timed in the mode each path
    takes, beside the bound, the plain composite and what the mode
    replaces (the walk kernel's runs then the plain post-pass, from Python
    and in a CUDA graph).  One call of each mode runs under
    torch.cuda.set_sync_debug_mode("error"): the kernel's route never
    waits for the card.  Returns {case: timing}."""
    import torch

    from ngsepcore_tpu_torch.kernels import pairwise
    from ngsepcore_tpu_torch.kernels.pairwise_cuda import gotoh_forward_plane

    rng = np.random.default_rng(6)
    tier3 = pairwise._walk_runs_for
    timed = [
        ("fused tier 3 2048x160x160", _bench_chunk(rng, 2048, 160, 160), {}, tier3(160)),
        ("classic tier 3 2048x192x192", _classic_chunk(rng, 2048), {}, tier3(192)),
        ("tier-2 left flank 256x160x384", _tier2_chunk(rng, 256, "left", Ls=384),
         TIER2_LEFT, 160 + 384),
        ("tier-2 right flank 256x160x224", _tier2_chunk(rng, 256, "right"),
         TIER2_RIGHT, 160 + 224),
    ] + [
        (f"long reads {kind} 512x{W}x{W}", _long_read_chunk(rng, 512, W, kind), cfg,
         tier3(W))
        for W in (128, 512) for kind, cfg in LONG_READ_CFGS.items()
    ]
    empty = _tier2_chunk(rng, 256, "left")
    empty[1][::4] = 0
    cases = timed + [
        ("runs past 255, R = Lq + Ls", _saturating(rng, 30, 300, 256), {}, 556),
        ("runs past 255, tier-3 budget", _saturating(rng, 30, 300, 256), {}, tier3(300)),
        ("budget runs out 256x160x160", _skip_seventh(rng, 256, 160), {}, tier3(160)),
        ("empty query with a free query end", empty, TIER2_LEFT, 160 + 224),
        # tier 2 over a ~1,500 bp STR: R = Lq + Ls
        ("tier-2 left flank 64x160x1664",
         _tier2_chunk(rng, 64, "left", Ls=1664), TIER2_LEFT, 160 + 1664),
        ("tier-2 right flank 64x160x1664",
         _tier2_chunk(rng, 64, "right", Ls=1664), TIER2_RIGHT, 160 + 1664),
        ("long reads budget runs out 512x512x512",
         _skip_seventh(rng, 512, 512), LONG_READ_CFGS["center"], tier3(512)),
    ]
    for name, data in _edge_cases(rng):
        for cfg in (_GOTOH_CFGS[0], TIER2_LEFT):
            Lq, Ls = data[0].shape[1], data[2].shape[1]
            cases.append((f"{name} {cfg}", data, cfg, tier3(Lq)))
            cases.append((f"{name} {cfg}, R = Lq + Ls", data, cfg, Lq + Ls))
    timed_names = {c[0] for c in timed}
    path_mode = lambda name: ("tier3" if "tier 3" in name else
                              "hamming" if name.startswith("long reads") else "runs")
    timing = {}

    def compare(name, wargs, q, s):
        """Every mode against its plain composite: {mode: kernel outputs}."""
        kernel, post = _walk_fns(wargs, q, s)
        ref = pairwise._runs_from_plane_ref(*wargs)
        got = {}
        for mode in WALK_MODES:
            got[mode] = kernel[mode]()
            want = post[mode](ref)
            bad = {k: int((got[mode][k] != want[k]).sum()) for k in want}
            if (set(got[mode]) != set(want) or any(bad.values())
                    or any(got[mode][k].dtype != want[k].dtype for k in want)):
                fail(f"the walk kernel's {mode} mode disagrees with its plain composite "
                     f"on {name}: {bad}")
        return got

    n_rows = n_out = 0
    for name, (q, ql, s, sl), cfg, R in cases:
        args = [torch.from_numpy(a).cuda() for a in (q, ql, s, sl)]
        plane, score, end_i, end_j, start_k = gotoh_forward_plane(*args, **cfg)
        fs2 = cfg.get("free_start2", True)
        B, Lq, Ls = plane.shape[1], plane.shape[0], plane.shape[2]
        wargs = (plane, score, end_i, end_j, start_k, B, R, fs2)
        got = compare(name, wargs, args[0], args[2])
        torch.cuda.synchronize()
        n_rows += B
        n_out += sum(v.numel() for g in got.values() for v in g.values())
        runs, t3 = got["runs"], got["tier3"]
        ok = int(runs["walk_ok"].sum())
        log(f"phase 2c walk {name}, R {R}: runs, tier3, hamming equal on {B} rows; "
            f"walk_ok {ok} of {B}, runs up to {int(runs['n_runs'].max())}, longest run "
            f"{int(runs['rlen'].max())}; gapped rows {int(t3['has_gap'].sum())}, "
            f"la_fallback {int(t3['la_fallback'].sum())}")
        if "budget runs out" in name and ok == B:
            fail(f"no row ran out of its budget on {name}")
        if "budget runs out" in name and not bool((t3["mism"] == 32000).any()):
            fail(f"no tier-3 row reports the exhausted budget on {name}")
        if name.startswith("runs past") and int(runs["rlen"].max()) <= 255:
            fail("no run past 255 on the saturating case")
        if name.startswith("empty query"):
            rows = torch.from_numpy(ql == 0).cuda()
            if not bool((runs["n_ops"][rows] == 0).all()) or int(rows.sum()) == 0:
                fail("the empty-query rows emitted columns")
        if name in timed_names:
            mode = path_mode(name)
            kernel, post = _walk_fns(wargs, args[0], args[2])
            ms = cuda_ms(kernel[mode], calls=20)
            g_ms = graph_ms(kernel[mode])
            plain = cuda_ms(lambda: post[mode](pairwise._runs_from_plane_ref(*wargs)))
            loads = walk_loads(plane, end_i, end_j, start_k, R)
            reads = walk_code_reads(runs, args[0], args[2]) if mode == "tier3" else 0
            b_ms, b_by = walk_bound(B, R, loads, mode, reads)
            t = dict(ms=ms, plain_ms=plain, max_abs_err=0, bound_ms=b_ms, bound_by=b_by,
                     graph_ms=g_ms, shape=f"{B}x{Lq}x{Ls} R {R}", mode=mode)
            text = ""
            if mode != "runs":
                # what the mode replaces: the walk's runs, then the plain post-pass
                replaced = lambda: post[mode](kernel["runs"]())
                t.update(walk_graph_ms=graph_ms(kernel["runs"]),
                         replaced_ms=cuda_ms(replaced, calls=5),
                         replaced_graph_ms=graph_ms(replaced, calls=5))
                text = (f"; replaces the runs mode ({t['walk_graph_ms']:.4f} ms in a graph) "
                        f"and the plain post-pass: {t['replaced_ms']:.4f} ms (median of 5 "
                        f"x 5 calls), {t['replaced_graph_ms']:.4f} ms in a CUDA graph of 5 "
                        f"calls")
            log(f"  time {name} R {R}, {mode} mode: kernel {ms:.4f} ms (median of 5 x 20 "
                f"calls), {g_ms:.4f} ms in a CUDA graph of 20 calls, plain {plain:.3f} ms "
                f"(median of 5); plane words read {int(loads.sum())}, longest chain "
                f"{int(loads.max())}, codes read {reads}; bound {b_ms:.4f} ms by {b_by}, "
                f"kernel at {100 * b_ms / ms:.1f}% of it ({100 * b_ms / g_ms:.1f}% in the graph)"
                + text)
            timing[name] = t
        del plane, got
    # the left-alignment's edges on synthetic planes, at both subject starts
    for fs2 in (True, False):
        B, Lq, Ls, R = 4096, 160, 192, 64
        plane, score, end_i, end_j, start_k, q, s = _runs_plane(rng, B, Lq, Ls, fs2)
        wargs = (plane, score, end_i, end_j, start_k, B, R, fs2)
        name = f"synthetic runs, free_start2 {fs2}"
        got = compare(name, wargs, q, s)
        runs, t3 = got["runs"], got["tier3"]
        valid = torch.arange(R, device="cuda")[None, :] < runs["n_runs"][:, None]
        gap = (runs["rop"] >= 2) & valid
        last = runs["rop"].gather(1, (runs["n_runs"] - 1).clamp(min=0).long()[:, None])[:, 0]
        reached = {
            "rows shifted": int(((t3["rle"].int() >> 2) != runs["rlen"]).any(dim=1).sum()),
            "la_fallback": int(t3["la_fallback"].sum()),
            "gap > LA_LMAX": int((gap & (runs["rlen"] > 16)).any(dim=1).sum()),
            "I then D": int((gap[:, 1:] & gap[:, :-1]).any(dim=1).sum()),
            "leading gap": int(gap[:, 0].sum()),
            "trailing gap": int((last >= 2).sum()),
            "N inside the alignment": int(((q == 4) & (torch.arange(Lq, device="cuda")[None, :]
                                                       < end_i[:, None])).any(dim=1).sum()),
        }
        log(f"phase 2c walk {name}, {B}x{Lq}x{Ls}, R {R}: runs, tier3, hamming equal; "
            f"reached {reached}")
        if min(reached.values()) == 0:
            fail(f"the synthetic runs did not reach every edge: {reached}")
        n_rows += B
        n_out += sum(v.numel() for g in got.values() for v in g.values())
        del plane, got
    # one chain alone: the kernel's own time a dependent step on this card
    q, ql, s, sl = _skip_seventh(rng, 1, 1024)
    args = [torch.from_numpy(a).cuda() for a in (q, ql, s, sl)]
    plane, score, end_i, end_j, start_k = gotoh_forward_plane(*args, free_start2=False,
                                                             free_end2=False)
    wargs = (plane, score, end_i, end_j, start_k, 1, 4096, False)
    ms1 = graph_ms(lambda: pairwise._runs_from_plane(*wargs))
    steps = int(walk_loads(plane, end_i, end_j, start_k, 4096).max())
    zero = end_i * 0  # a walk that is done before its first step
    ms0 = graph_ms(lambda: pairwise._runs_from_plane(plane, score, zero, zero, start_k,
                                                     1, 4096, True))
    log(f"  lone chain of {steps} steps: {ms1:.4f} ms, {ms0:.4f} ms for a walk of "
        f"0 steps; {1e6 * (ms1 - ms0) / max(steps, 1):.1f} ns a step beside the "
        f"{1e9 * L2_HIT_CYCLES / SM_CLOCK_HZ:.1f} ns the bound takes")
    # offsets past 2^31 cells
    B, Lq, Ls = 2048, 1100, 1024
    plane = _wide_plane(rng, B, Lq, Ls)
    end_i = torch.full((B,), Lq, dtype=torch.int32, device="cuda")
    end_j = torch.from_numpy(rng.integers(Ls // 2, Ls + 1, B).astype(np.int32)).cuda()
    start_k = torch.from_numpy(rng.integers(0, 3, B).astype(np.int32)).cuda()
    q = torch.randint(0, 5, (B, Lq), dtype=torch.int8, device="cuda")
    s = torch.randint(0, 5, (B, Ls), dtype=torch.int8, device="cuda")
    got = compare("a plane of more than 2^31 cells",
                  (plane, end_j * 0, end_i, end_j, start_k, B, 72, False), q, s)
    log(f"phase 2c walk {B}x{Lq}x{Ls} ({B * Lq * Ls} cells), R 72: runs, tier3, hamming "
        f"equal; runs up to {int(got['runs']['n_runs'].max())}")
    del plane, got, q, s
    torch.cuda.empty_cache()
    # no host sync on the kernel's route, in any mode
    q, ql, s, sl = _bench_chunk(rng, 2048, 160, 160)
    args = [torch.from_numpy(a).cuda() for a in (q, ql, s, sl)]
    plane, score, end_i, end_j, start_k = gotoh_forward_plane(*args)
    kernel, _ = _walk_fns((plane, score, end_i, end_j, start_k, 2048, 28, True),
                          args[0], args[2])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for mode in WALK_MODES:
            kernel[mode]()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"phase 2c walk: {len(cases) + 3} cases, {n_rows} rows, {n_out} outputs in the "
        "three modes, 0 differing; one call a mode under set_sync_debug_mode('error') "
        "ran without a sync")
    return timing


def phase_shear():
    import torch

    from ngsepcore_tpu_torch.kernels.shear_pileup import shear_hist, shear_hist_ref

    rng = np.random.default_rng(1)
    lanes, window = 160, 1 << 20
    S = lanes + window + 256
    timing = {}
    for nq in (1, 6):
        ncnt = 4 * nq + 2
        col = rng.integers(0, ncnt, (lanes, S))
        strand = rng.integers(0, 2, (lanes, S))
        st = (col | (strand << 7)).astype(np.uint8)
        st[rng.random((lanes, S)) < 0.4] = 0xFF
        stage = torch.from_numpy(st).cuda()
        w0s = lanes - 1  # window starts at the halo
        kern = shear_hist(stage, w0s, window=window, nq=nq, lanes=lanes)
        ref = shear_hist_ref(stage, w0s, window=window, nq=nq, lanes=lanes)
        torch.cuda.synchronize()
        bad = int((kern != ref).sum())
        err = int((kern - ref).abs().max())
        log(f"phase 3 shear nq={nq} window={window} lanes={lanes}: "
            f"mismatches {bad}")
        if bad:
            fail(f"shear kernel disagrees with its plain version (nq={nq})")
        ms = cuda_ms(lambda: shear_hist(stage, w0s, window=window, nq=nq, lanes=lanes),
                     calls=20)
        plain = cuda_ms(
            lambda: shear_hist_ref(stage, w0s, window=window, nq=nq, lanes=lanes)
        )
        b_ms, b_by = bound(stage.numel() + 4 * kern.numel(),
                           SHEAR_OPS_PER_BYTE * stage.numel())
        log(f"  time nq={nq}: kernel {ms:.4f} ms (median of 5 x 20 calls), plain "
            f"{plain:.3f} ms (median of 5); bound {b_ms:.4f} ms by {b_by}, "
            f"kernel at {100 * b_ms / ms:.1f}% of it")
        timing[nq] = dict(ms=ms, plain_ms=plain, max_abs_err=err,
                          bound_ms=b_ms, bound_by=b_by)
        del stage, kern, ref
    return timing


# ---------------------------------------------------------------------------
def _depth_vector(rng, T, mean=4.0):
    """Reads per 100 bp bin at 6x of 150 bp reads, with a 2x and a 0x
    segment planted where T leaves room."""
    depth = rng.poisson(mean, size=T).astype(np.float64)
    if T >= 1000:
        a = T // 4
        depth[a : a + 200] = rng.poisson(2 * mean, size=200)
        b = (2 * T) // 3
        depth[b : b + 100] = 0.0
    return depth


def _poisson_hmm(rng, T, S=5, mean=4.0, p=0.001):
    """(log_start, log_trans (1,S,S), log_emit (T,S)) as
    PoissonHMMReadDepthAlgorithm.call_cnvs makes them."""
    import math

    from ngsepcore_tpu_torch.call.read_depth import _poisson_log10

    trans = np.full((S, S), p / (S - 1))
    np.fill_diagonal(trans, 1 - p)
    lam = np.maximum(mean * np.arange(S)[None, :] / 2, mean * 0.05)
    # a row depends on its depth only: each distinct depth's row once
    depth, row = np.unique(np.round(_depth_vector(rng, T, mean)), return_inverse=True)
    emit = _poisson_log10(depth[:, None], lam)[row.reshape(-1)]
    return np.full(S, -math.log10(S)), np.log10(trans)[None], emit


def _random_hmm(rng, T, S, per_step=False, neg_inf=False):
    start = np.log10(rng.dirichlet(np.ones(S)))
    n = T - 1 if per_step else 1
    trans = rng.dirichlet(np.ones(S), size=(n, S))
    if neg_inf:
        forbid = rng.random((n, S, S)) < 0.3
        forbid[:, np.arange(S), np.arange(S)] = False
        trans = np.where(forbid, 0.0, trans)
    with np.errstate(divide="ignore"):
        trans = np.log10(trans)
    return start, trans, np.log10(rng.random((T, S)))


def _signed_zero_hmm(rng, T, S):
    """Start -0.0, transitions +-0.0 at random, emissions -0.0 with a few
    +0.0: every candidate ties, and the best score's sign is that of a
    maximum that orders -0.0 below +0.0 (the JAX package's jnp.max), where
    the first maximum's sum can be -0.0."""
    start = np.full(S, -0.0)
    trans = np.where(rng.random((1, S, S)) < 0.5, -0.0, 0.0)
    return start, trans, np.where(rng.random((T, S)) < 0.03, 0.0, -0.0)


# GRCh38's chromosome lengths (bp): a human genome in 100 bp bins is the
# read-depth callers' sequences at user size
GRCH38 = {
    "chr1": 248_956_422, "chr2": 242_193_529, "chr3": 198_295_559, "chr4": 190_214_555,
    "chr5": 181_538_259, "chr6": 170_805_979, "chr7": 159_345_973, "chr8": 145_138_636,
    "chr9": 138_394_717, "chr10": 133_797_422, "chr11": 135_086_622, "chr12": 133_275_309,
    "chr13": 114_364_328, "chr14": 107_043_718, "chr15": 101_991_189, "chr16": 90_338_345,
    "chr17": 83_257_441, "chr18": 80_373_285, "chr19": 58_617_616, "chr20": 64_444_167,
    "chr21": 46_709_983, "chr22": 50_818_468, "chrX": 156_040_895, "chrY": 57_227_415,
}


def _batch_of(hmms):
    """(start (n,S), trans (n,S,S), emits (sum T,S), lengths) of shared-
    transition HMMs, on the card."""
    import torch

    lengths = [len(h[2]) for h in hmms]
    emits = np.empty((sum(lengths), hmms[0][2].shape[1]))
    r0 = 0
    for h, T in zip(hmms, lengths):
        emits[r0 : r0 + T] = h[2]
        r0 += T
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).cuda()
    return (up(np.stack([h[0] for h in hmms])), up(np.concatenate([h[1] for h in hmms])),
            up(emits), lengths)


def _viterbi_human_scale(rng, chain_cycles):
    """24 sequences of Poisson emissions at GRCh38's lengths in 100 bp bins
    (30.9 M steps) in one launch, timed beside the 24 batch-of-one launches
    summed; every sequence's batched path and best equal to its own launch
    (the plain loop would take over 20 minutes)."""
    import torch

    from ngsepcore_tpu_torch.kernels.hmm import viterbi_log, viterbi_log_batch

    hmms = [_poisson_hmm(rng, -(-L // 100)) for L in GRCH38.values()]
    start, trans, emits, lengths = _batch_of(hmms)
    del hmms
    batch = lambda: viterbi_log_batch(start, trans, emits, lengths)
    paths, best = batch()
    ms = cuda_ms(batch, reps=3)
    alone_ms, r0 = 0.0, 0
    for b, T in enumerate(lengths):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        path, one = viterbi_log(start[b], trans[b : b + 1], emits[r0 : r0 + T])
        z.record()
        torch.cuda.synchronize()
        alone_ms += a.elapsed_time(z)
        if not (torch.equal(path, paths[r0 : r0 + T])
                and bool(one.view(torch.int64) == best[b].view(torch.int64))):
            fail(f"the batched path of {list(GRCH38)[b]} differs from its own launch")
        r0 += T
    n1 = lengths[0]
    # the launch lasts as long as its longest sequence's chain; bytes of all
    b_ms = max(viterbi_bound(n1, 5, chain_cycles)[0],
               viterbi_bound(sum(lengths), 5, chain_cycles)[2])
    log(f"  human scale, 24 GRCh38 sequences in 100 bp bins ({sum(lengths)} steps, chr1 "
        f"{n1}): one launch {ms:.3f} ms ({ms * 1e6 / n1:.2f} ns a step of chr1), bound "
        f"{b_ms:.3f} ms (chr1's chain), {100 * b_ms / ms:.1f}% of it; the 24 batch-of-one "
        f"launches {alone_ms:.3f} ms summed; every batched path and best equal to its own "
        f"launch's")
    return dict(ms=ms, alone_ms=alone_ms, steps=sum(lengths), chr1=n1, bound_ms=b_ms)


def _cnv_three_sequences(rng):
    """A genome of three sequences (200, 100 and 50 kb) and 100 bp reads at
    20x with a duplication on the first and a deletion on the second, as
    alignments."""
    from ngsepcore_tpu_torch.align.read_alignment import ReadAlignment
    from ngsepcore_tpu_torch.core.genome import ReferenceGenome
    from ngsepcore_tpu_torch.core.sequences import QualifiedSequence, QualifiedSequenceList

    seqs = QualifiedSequenceList()
    alns = []
    for name, L, event, factor in (("s1", 200_000, (60_000, 70_000), 2),
                                    ("s2", 100_000, (40_000, 46_000), 0),
                                    ("s3", 50_000, None, 1)):
        seqs.add(QualifiedSequence(name=name, codes=rng.integers(0, 4, size=L).astype(np.int8)))
        starts = rng.integers(1, L - 100, size=L * 20 // 100)
        if factor == 0:
            starts = starts[(starts < event[0]) | (starts >= event[1])]
        elif factor == 2:
            lo, hi = event
            starts = np.concatenate([starts, rng.integers(lo, hi - 100, size=(hi - lo) // 5)])
        alns += [ReadAlignment(sequence_name=name, first=int(s), cigar=[(100, "M")],
                               read_chars="A" * 100) for s in np.sort(starts)]
    return ReferenceGenome(seqs), alns


def _device_to_host_copies(fn):
    """fn()'s result and the device-to-host copies torch.profiler saw during
    it, beside the CUDA kernels it saw (to tell an empty trace apart)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, sum("DtoH" in n for n in names), sum("viterbi_kernel" in n for n in names)


VITERBI_POISSON_T = (1, 2, 33, 46_000, 120_000)  # phase 2b's Poisson cases, in order


def _viterbi_poisson_ref_cpu(T):
    """Phase 2b's plain reference for its Poisson S=5 case of T steps, in a
    process of its own: the Poisson cases drawn again from rng 5 in phase
    2b's order, viterbi_log_ref on the CPU with two torch threads; (path,
    best) as numpy arrays."""
    import torch

    from ngsepcore_tpu_torch.kernels.hmm import viterbi_log_ref

    torch.set_num_threads(2)
    rng = np.random.default_rng(5)
    cases = {t: _poisson_hmm(rng, t) for t in VITERBI_POISSON_T}
    path, best = viterbi_log_ref(*(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))
                                   for a in cases[T]))
    return path.numpy(), best.numpy()


def phase_viterbi():
    """The Viterbi kernel against the plain step loop on the card: path
    and best score bit for bit, one sequence a launch and ragged batches;
    the human-scale batch against its sequences' own launches; a
    three-sequence find_cnv_calls on the card against the CPU, one launch
    and one device-to-host copy an HMM algorithm; the latency of each link
    of a step's chain, whose sum at the timed S is the bound."""
    import torch

    from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector
    from ngsepcore_tpu_torch.kernels.hmm import viterbi_log, viterbi_log_batch, viterbi_log_ref

    # the longest case's plain reference (~15 s of host) runs meanwhile
    ref_longest = _InBackground(functools.partial(_viterbi_poisson_ref_cpu,
                                                  VITERBI_POISSON_T[-1]))
    lat = viterbi_latencies()
    log("phase 2b viterbi chain links, cycles: " + ", ".join(
        f"{k} {lat[k]:.2f}" for k in VITERBI_LATENCY_KINDS))
    rng = np.random.default_rng(5)
    cases = [(f"Poisson S=5 T={T}", _poisson_hmm(rng, T)) for T in VITERBI_POISSON_T]
    cases += [
        ("random S=32 T=2000", _random_hmm(rng, 2000, 32)),
        ("random S=1 T=50", _random_hmm(rng, 50, 1)),
        ("random S=7 T=777", _random_hmm(rng, 777, 7)),
        ("random S=12 T=500", _random_hmm(rng, 500, 12)),
        ("per-step transitions S=5 T=5000", _random_hmm(rng, 5000, 5, per_step=True)),
        ("per-step transitions S=32 T=300", _random_hmm(rng, 300, 32, per_step=True)),
        ("-inf transitions S=6 T=3000", _random_hmm(rng, 3000, 6, neg_inf=True)),
        ("-inf per-step transitions S=6 T=1000",
         _random_hmm(rng, 1000, 6, per_step=True, neg_inf=True)),
        # every path scores the same: each argmax is a tie, state 0 must win
        ("tie S=4 T=500", (np.zeros(4), np.zeros((1, 4, 4)), -np.ones((500, 4)))),
        ("signed zeros S=5 T=300", _signed_zero_hmm(rng, 300, 5)),
        ("signed zeros S=3 T=40", _signed_zero_hmm(rng, 40, 3)),
        # signed zeros, then random emissions: exact chunks, then plain ones
        ("signed zeros then random S=5 T=3000", _signed_zero_hmm(rng, 3000, 5)[:2]
         + (np.concatenate([_signed_zero_hmm(rng, 600, 5)[2],
                            np.log10(rng.random((2400, 5)))]),)),
    ]
    same = lambda a, b: bool(a.view(torch.int64) == b.view(torch.int64))
    timing, refs = None, {}
    for name, arrays in cases:
        args = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).cuda()
                for a in arrays]
        path, best = viterbi_log(*args)
        torch.cuda.synchronize()
        # the plain loop on the CPU: the same adds, maxima and ties as on
        # the card, at a step's host cost instead of its launches'
        if name == f"Poisson S=5 T={VITERBI_POISSON_T[-1]}":
            want = (torch.from_numpy(x) for x in ref_longest.result("phase 2b"))
        else:
            want = viterbi_log_ref(*(a.cpu() for a in args))
        want_path, want_best = (x.cuda() for x in want)
        refs[name] = (arrays, want_path, want_best)
        bad = int((path != want_path).sum())
        same_best = same(best, want_best)
        err = 0.0 if same_best else abs(float(best) - float(want_best))
        states = torch.bincount(path.long(), minlength=args[2].shape[1]).tolist()
        log(f"phase 2b viterbi {name}: path mismatches {bad} of {path.numel()}, best "
            f"{float(best):.6f} bit-equal {same_best}; states used {states}")
        if bad or not same_best:
            fail(f"the Viterbi kernel disagrees with its plain version on {name}")
        if name.startswith("tie") and int(path.abs().sum()) != 0:
            fail("a tie did not go to the first state")
        if name == "Poisson S=5 T=46000":
            if min(states[0], states[4]) == 0:
                fail("the planted 0x and 2x segments were not decoded")
            T, S = args[2].shape
            ms = cuda_ms(lambda: viterbi_log(*args), calls=20)
            plain = cuda_ms(lambda: viterbi_log_ref(*args), reps=1)
            chain = viterbi_chain_cycles(lat, S)
            b_ms, b_by, t_bytes, t_chain = viterbi_bound(T, S, chain)
            log(f"  time T={T} S={S}: kernel {ms:.4f} ms (median of 5 x 20 calls), "
                f"{ms * 1e6 / T:.2f} ns a step, plain {plain:.1f} ms (one call); bound "
                f"{b_ms:.4f} ms by {b_by} (measured chain {chain:.2f} cycles a step = "
                f"{t_chain:.4f} ms at {SM_CLOCK_HZ / 1e9:.2f} GHz, bytes {t_bytes:.6f}), "
                f"kernel at {100 * b_ms / ms:.1f}% of it")
            timing = dict(ms=ms, plain_ms=plain, max_abs_err=err + bad,
                          bound_ms=b_ms, bound_by=b_by, shape=f"T={T} S={S}",
                          chain_cycles=chain)

    # ragged batches: every sequence against its own plain loop
    batches = [(f"ragged S={S}", [_random_hmm(rng, T, S) for T in (1, 2, 33, 257, 4000)])
               for S in (1, 5, 32)]
    batches.append(("signed zeros, ragged S=5",
                    [_signed_zero_hmm(rng, T, 5) for T in (1, 40, 300)]))
    big = refs["Poisson S=5 T=120000"][0]
    one = refs["Poisson S=5 T=1"][0]
    batches.append(("T=1 beside T=120000", [one, big, one]))
    for name, hmms in batches:
        start, trans, emits, lengths = _batch_of(hmms)
        paths, best = viterbi_log_batch(start, trans, emits, lengths)
        torch.cuda.synchronize()
        r0, bad = 0, 0
        for b, (h, T) in enumerate(zip(hmms, lengths)):
            want_path, want_best = (refs["Poisson S=5 T=120000"][1:] if h is big else
                                    viterbi_log_ref(start[b], trans[b : b + 1],
                                                    emits[r0 : r0 + T]))
            bad += int((paths[r0 : r0 + T] != want_path).sum())
            bad += not same(best[b], want_best)
            r0 += T
        log(f"phase 2b viterbi batch {name}, T {lengths}: one launch, {bad} path entries or "
            f"best scores differ from the plain loop")
        if bad:
            fail(f"the Viterbi kernel's batch {name} disagrees with its plain version")

    timing["human"] = _viterbi_human_scale(rng, timing["chain_cycles"])

    # find_cnv_calls over three sequences, the card against the CPU
    genome, alns = _cnv_three_sequences(rng)
    calls = {}
    for dev in ("cuda", "cpu"):
        det = SingleSampleVariantsDetector(genome, alg_cnv=ALL_CNV_ALGORITHMS, device=dev)
        calls[dev] = det.find_cnv_calls(alns)
    if not calls["cuda"] or _call_fields(calls["cuda"]) != _call_fields(calls["cpu"]):
        fail("three-sequence CNV calls differ between CUDA and CPU")
    for alg in ("PoissonHMM", "MAXIMUMLIKELIHOOD"):
        det = SingleSampleVariantsDetector(genome, alg_cnv=alg, device="cuda")
        before = viterbi_log.launches
        own, n_copies, n_kernels = _device_to_host_copies(lambda: det.find_cnv_calls(alns))
        n_launch = viterbi_log.launches - before
        log(f"  three sequences, {alg}: {len(own)} calls on {sorted({c.sequence_name for c in own})}, "
            f"Viterbi launches {n_launch}, device-to-host copies {n_copies} (profiler: "
            f"{n_kernels} Viterbi kernels)")
        if n_launch != 1 or n_kernels != 1 or n_copies != 1:
            fail(f"{alg}.call_cnvs over three sequences did not take one launch and one copy")
    log(f"  three-sequence find_cnv_calls, {ALL_CNV_ALGORITHMS}: {len(calls['cuda'])} calls, "
        f"equal on CUDA and the CPU")
    return timing


# ---------------------------------------------------------------------------
def record_key(rec):
    """tests/test_fused_pipeline.py's record identity."""
    v = rec.variant
    c = rec.calls[0]
    return (
        v.sequence_name, v.first, tuple(v.alleles),
        tuple(c.indexes_called_alleles), int(c.genotype_quality),
        int(round(v.quality)), int(c.total_read_depth),
        tuple(c.acgt_depths or []), tuple(c.genotype_likelihoods or []),
    )


def _simulate_50kb(seed: int = 3):
    """tests/test_fused_pipeline.py::_simulate(with_indels=True)."""
    from ngsepcore_tpu_torch.core.genome import ReferenceGenome
    from ngsepcore_tpu_torch.core.sequences import QualifiedSequence, QualifiedSequenceList
    from ngsepcore_tpu_torch.simulation.individual_simulator import SingleIndividualSimulator
    from ngsepcore_tpu_torch.simulation.reads_simulator import SingleReadsSimulator

    rng = np.random.default_rng(seed)
    seqs = QualifiedSequenceList()
    seqs.add(QualifiedSequence(name="chrA", codes=rng.integers(0, 4, size=30000).astype(np.int8)))
    seqs.add(QualifiedSequence(name="chrB", codes=rng.integers(0, 4, size=20000).astype(np.int8)))
    genome = ReferenceGenome(seqs)
    sim = SingleIndividualSimulator(genome, snv_rate=0.002, indel_rate=0.0005, seed=seed + 1)
    sim.simulate()
    reads = []
    for h, hg in enumerate(sim.build_haplotype_genomes()):
        reads.extend(
            SingleReadsSimulator(
                hg, read_length=100, substitution_error_rate=0.004, seed=seed + 10 + h
            ).simulate(2500)
        )
    for i in range(0, len(reads), 97):
        s = list(reads[i].sequence)
        s[len(s) // 2] = "N"
        reads[i] = type(reads[i])(name=reads[i].name, sequence="".join(s),
                                  qualities=reads[i].qualities)
    return genome, reads


def _make_pipeline(genome, device, batch_size, table=None, known_strs=None):
    from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner
    from ngsepcore_tpu_torch.call.fused_pipeline import AlignCallPipeline
    from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector

    detector = SingleSampleVariantsDetector(genome, sample_id="s1", device=device)
    if known_strs:
        detector.known_strs = known_strs  # the pipeline hands it to the aligner
    return AlignCallPipeline(
        genome, aligner=ReadsAligner(genome, table=table, device=device),
        detector=detector, batch_size=batch_size, device=device,
    )


def _run_pipeline(genome, reads, device, batch_size, table=None):
    pipe = _make_pipeline(genome, device, batch_size, table)
    return pipe, pipe.run_reads(reads)


def phase_cuda_vs_cpu(counters):
    import torch

    genome, reads = _simulate_50kb()
    reset_counts(counters)
    t0 = time.perf_counter()
    with plain_post_pass_forbidden():
        _, rec_cuda = _run_pipeline(genome, reads, "cuda", 1024)
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    walk_route(counters, "tier3", "phase 4, fused")
    t0 = time.perf_counter()
    _, rec_cpu = _run_pipeline(genome, reads, "cpu", 1024)
    t_cpu = time.perf_counter() - t0
    kc = [record_key(r) for r in rec_cuda]
    kp = [record_key(r) for r in rec_cpu]
    log(f"phase 4 50 kb indel workload: {len(kc)} records on CUDA "
        f"({t_cuda:.2f}s), {len(kp)} on CPU ({t_cpu:.2f}s), launches {launches}")
    if len(kc) <= 10 or kc != kp:
        fail("CUDA and CPU records differ on the 50 kb workload")
    if min(launches.values()) == 0:
        fail(f"a kernel was not launched on the CUDA run: {launches}")
    return kc


SORTED_KEY_SWITCH = 1 << 24  # MinimizerTable.MAX_BUCKETIZED_CODES, the reference's
FORCED_SWITCH = 1 << 10  # below the 50 kb genome's distinct codes


def _sorted_key_on(table, device):
    """Fail unless `table` answers with the sorted-key layout on `device`
    and holds no copy on another device."""
    import torch

    from ngsepcore_tpu_torch.index.minimizer_table import SortedKeyTable

    arr = table.device_arrays(device)
    dev = torch.device(device)
    if not isinstance(arr, SortedKeyTable) or any(x.device.type != dev.type for x in arr):
        fail(f"the table did not take the sorted-key layout on {device}")
    if any(d.type != dev.type for d in table._device_arrays):
        fail(f"the table was copied off {device}: {list(table._device_arrays)}")
    return arr


def phase_sorted_key_50kb(counters, bucket_keys, device="cuda"):
    """Phase 4's 50 kb input with the sorted-key layout forced: fused
    records, classic SAM lines and seeds on CUDA equal to the CPU's, and,
    with no code culled, the fused records equal to the bucket layout's.
    The layout is forced by setting MinimizerTable.MAX_BUCKETIZED_CODES low
    on the class for the phase."""
    from unittest import mock

    from ngsepcore_tpu_torch.index.minimizer_table import MinimizerTable

    genome, reads = _simulate_50kb()
    with mock.patch.object(MinimizerTable, "MAX_BUCKETIZED_CODES", FORCED_SWITCH):
        reset_counts(counters)
        t0 = time.perf_counter()
        with plain_post_pass_forbidden():
            pipe, rec_cuda = _run_pipeline(genome, reads, device, 1024)
        sync(device)
        t_cuda = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        walk_route(counters, "tier3", "phase 4, sorted-key fused")
        arr = _sorted_key_on(pipe.aligner.table, device)
        culled = len(pipe.aligner.table.unique_codes) - arr.keys.shape[0]
        _, rec_cpu = _run_pipeline(genome, reads, "cpu", 1024)
        with plain_post_pass_forbidden():
            sam_cuda, _, al_cuda = _run_classic(genome, reads, device)
        _sorted_key_on(al_cuda.table, device)
        sam_cpu, _, al_cpu = _run_classic(genome, reads, "cpu")
        seeds_cuda = al_cuda._seed(reads[:2048])[3]
        seeds_cpu = al_cpu._seed(reads[:2048])[3]
    kc = [record_key(r) for r in rec_cuda]
    kp = [record_key(r) for r in rec_cpu]
    seed_diff = [k for k in seeds_cpu if not np.array_equal(seeds_cuda[k], seeds_cpu[k])]
    n_sam_diff = sum(a != b for a, b in zip(sam_cuda, sam_cpu))
    log(f"phase 4 sorted-key layout forced ({arr.keys.shape[0]} keys, {culled} culled): "
        f"fused {len(kc)} records on CUDA ({t_cuda:.2f}s), {len(kp)} on CPU, launches "
        f"{launches}; classic {len(sam_cuda)} SAM lines, {n_sam_diff} differing; seeds of "
        f"2,048 reads differing in {seed_diff or 'no field'}")
    if len(kc) <= 10 or kc != kp:
        fail("sorted-key layout: CUDA and CPU fused records differ")
    if len(sam_cuda) != len(sam_cpu) or n_sam_diff:
        fail("sorted-key layout: CUDA and CPU classic SAM lines differ")
    if seed_diff:
        fail(f"sorted-key layout: CUDA and CPU seeds differ in {seed_diff}")
    if culled == 0 and kc != bucket_keys:
        fail("sorted-key layout: with no code culled, the records differ from the bucket layout's")
    if device == "cuda" and min(launches.values()) == 0:
        fail(f"a kernel was not launched on the sorted-key run: {launches}")


ANCHOR_BP = 250_000  # tests/test_accuracy_anchor.py's input and gates
ANCHOR_COVERAGE = 30


def anchor_inputs(classes=None):
    """tests/test_accuracy_anchor.py's input: 30x of 150 bp reads (0.003
    error, seeds 100 and 101) over 250 kb (rng 2025) of one diploid
    individual (SNV 0.001, indel 0.0002, seed 9), built with `classes`
    (port_classes() by default).  Returns (genome, reads, simulator)."""
    k = classes or port_classes()
    rng = np.random.default_rng(2025)
    seqs = k.QualifiedSequenceList()
    seqs.add(k.QualifiedSequence(
        name="chr1", codes=rng.integers(0, 4, size=ANCHOR_BP).astype(np.int8)))
    genome = k.ReferenceGenome(seqs)
    sim = k.SingleIndividualSimulator(genome, snv_rate=0.001, indel_rate=0.0002, seed=9)
    sim.simulate()
    n_reads = ANCHOR_BP * ANCHOR_COVERAGE // READ_LEN
    reads = k.ReadBlock.concatenate([
        k.SingleReadsSimulator(
            hg, read_length=READ_LEN, substitution_error_rate=0.003, seed=100 + h
        ).simulate_block(n_reads // 2)
        for h, hg in enumerate(sim.build_haplotype_genomes())
    ])
    return genome, reads, sim


def phase_anchor_30x(counters, device="cuda"):
    """tests/test_accuracy_anchor.py on the card: 30x of 150 bp reads over
    250 kb through AlignCallPipeline; SNV recall and precision >= 0.95,
    indel recall >= 0.90 (within 5 bp)."""
    genome, reads, sim = anchor_inputs()
    reset_counts(counters)
    t0 = time.perf_counter()
    _, records = _run_pipeline(genome, reads, device, 16384)
    sync(device)
    dt = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    truth_snv = {(c.first, c.alleles[1]) for c in sim.calls if c.is_snv}
    called_snv = {(r.variant.first, r.variant.alleles[1]) for r in records
                  if r.variant.is_snv and len(r.variant.alleles) > 1}
    tp = len(called_snv & truth_snv)
    recall, precision = tp / max(1, len(truth_snv)), tp / max(1, len(called_snv))
    ti = np.array(sorted(c.first for c in sim.calls if not c.is_snv), np.int64)
    ci = np.array(sorted(r.variant.first for r in records if not r.variant.is_snv), np.int64)
    if len(ci):
        j = np.clip(np.searchsorted(ci, ti), 0, len(ci) - 1)
        jm = np.clip(j - 1, 0, len(ci) - 1)
        near = (np.abs(ci[j] - ti) <= 5) | (np.abs(ci[jm] - ti) <= 5)
    else:
        near = np.zeros(len(ti), bool)
    indel_recall = float(near.mean()) if len(ti) else 1.0
    log(f"phase 4 30x anchor: {len(reads)} reads over {ANCHOR_BP} bp on {device} "
        f"({dt:.2f}s), {len(records)} records; SNV recall {recall:.4f}, precision "
        f"{precision:.4f} of {len(truth_snv)}; indel recall {indel_recall:.4f} of {len(ti)}; "
        f"launches {launches}")
    if len(truth_snv) <= 150 or len(ti) <= 30:
        fail("30x anchor: too few planted variants")
    if recall < 0.95 or precision < 0.95 or indel_recall < 0.90:
        fail("30x anchor gates: SNV recall and precision >= 0.95, indel recall >= 0.90")
    if device == "cuda" and min(launches.values()) == 0:
        fail(f"a kernel was not launched on the 30x anchor run: {launches}")
    return {"snv_recall": recall, "snv_precision": precision, "indel_recall": indel_recall}


# ---------------------------------------------------------------------------
GENOME_MBP = 4.6
N_READS = 345_000
READ_LEN = 150


def build_repeat_genome(rng, L: int, n_families: int, n_tandem: int):
    """bench.build_repeat_genome with its family and tandem-array counts as
    parameters: dispersed families at 92-99% identity plus short tandem
    arrays.  Returns (codes, merged repeat intervals, the tandem arrays as
    0-based half-open (start, end) in planting order, the families as
    (source start, length, source segment, copy starts) in planting
    order)."""
    codes = rng.integers(0, 4, size=L).astype(np.int8)
    intervals = []
    tandem = []
    families = []
    for _fam in range(n_families):
        slen = int(rng.integers(500, 4000))
        src = int(rng.integers(0, L - slen))
        seg = codes[src : src + slen].copy()
        intervals.append((src, src + slen))
        families.append((src, slen, seg, []))
        for _copy in range(int(rng.integers(4, 16))):
            dst = int(rng.integers(0, L - slen))
            families[-1][3].append(dst)
            cp = seg.copy()
            div = float(rng.uniform(0.01, 0.08))
            nmut = int(rng.binomial(slen, div))
            if nmut:
                mpos = rng.choice(slen, size=nmut, replace=False)
                cp[mpos] = (cp[mpos] + rng.integers(1, 4, size=nmut)) % 4
            codes[dst : dst + slen] = cp
            intervals.append((dst, dst + slen))
    for _t in range(n_tandem):
        mlen = int(rng.integers(2, 7))
        ncopies = int(rng.integers(8, 41))
        span = mlen * ncopies
        dst = int(rng.integers(0, L - span))
        codes[dst : dst + span] = np.tile(
            rng.integers(0, 4, size=mlen).astype(np.int8), ncopies
        )
        intervals.append((dst, dst + span))
        tandem.append((dst, dst + span))
    intervals.sort()
    merged = [list(intervals[0])]
    for lo, hi in intervals[1:]:
        if lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return codes, np.asarray(merged, dtype=np.int64), tandem, families


def str_catalogue(name: str, arrays, region_class=None):
    """A known-STR catalogue {sequence name: sorted regions} from 0-based
    half-open tandem arrays; an array that overlaps an earlier one is
    merged into it, so the regions are disjoint.  The regions are
    `region_class`'s (a package's GenomicRegion, the port's by default)."""
    if region_class is None:
        from ngsepcore_tpu_torch.core.regions import GenomicRegion as region_class

    regions = []
    for lo, hi in sorted(arrays):
        if regions and lo + 1 <= regions[-1].last:
            regions[-1].last = max(regions[-1].last, hi)
        else:
            regions.append(region_class(name, lo + 1, hi))
    return {name: regions}


def port_classes():
    """The port's classes (and reverse complement) that real_size_inputs,
    rice_sized_genome and _sim_asm_reads build with."""
    from types import SimpleNamespace

    from ngsepcore_tpu_torch.core.genome import ReferenceGenome
    from ngsepcore_tpu_torch.core.sequences import (
        QualifiedSequence,
        QualifiedSequenceList,
        ReadBlock,
        reverse_complement_codes,
    )
    from ngsepcore_tpu_torch.simulation.individual_simulator import SingleIndividualSimulator
    from ngsepcore_tpu_torch.simulation.reads_simulator import SingleReadsSimulator

    return SimpleNamespace(
        ReferenceGenome=ReferenceGenome, QualifiedSequence=QualifiedSequence,
        QualifiedSequenceList=QualifiedSequenceList, ReadBlock=ReadBlock,
        SingleIndividualSimulator=SingleIndividualSimulator,
        SingleReadsSimulator=SingleReadsSimulator,
        reverse_complement_codes=reverse_complement_codes,
    )


def real_size_inputs(mbp=GENOME_MBP, n_reads=N_READS, classes=None,
                     with_reads=True) -> dict:
    """bench.py's workload at `mbp` Mbp and `n_reads` reads (bench.py's own
    at 12.0 and 900,000): build_repeat_genome(default_rng(2024)) with
    bench's 30 families and 400 tandem arrays scaled by mbp / 12, one
    diploid individual (SNV 0.001, indel 0.0001, seed 7), two haplotypes x
    n_reads / 2 reads of 150 bp at 0.003 error (seeds 11 and 12).
    `classes` holds a package's ReferenceGenome, QualifiedSequence,
    QualifiedSequenceList, ReadBlock, SingleIndividualSimulator and
    SingleReadsSimulator (port_classes() by default).  Returns codes,
    repeat_iv (merged), tandem, genome, reads (None, and not simulated,
    unless `with_reads`), truth_snv {(first, alt)},
    truth_indel_pos and in_repeat (bench.check_accuracy's mask)."""
    k = classes or port_classes()
    rng = np.random.default_rng(2024)
    L = int(mbp * 1e6)
    scale = mbp / 12.0
    codes, repeat_iv, tandem, _ = build_repeat_genome(
        rng, L, round(30 * scale), round(400 * scale)
    )

    def genome_of():
        seqs = k.QualifiedSequenceList()
        seqs.add(k.QualifiedSequence(name="chr1", codes=codes))
        return k.ReferenceGenome(seqs)

    sim = k.SingleIndividualSimulator(genome_of(), snv_rate=0.001, indel_rate=0.0001, seed=7)
    sim.simulate()
    reads = None
    if with_reads:
        reads = k.ReadBlock.concatenate([
            k.SingleReadsSimulator(
                hg, read_length=READ_LEN, substitution_error_rate=0.003, seed=11 + h
            ).simulate_block(n_reads // 2)
            for h, hg in enumerate(sim.build_haplotype_genomes())
        ])
    in_repeat = np.zeros(L + 2, bool)
    for lo, hi in repeat_iv:
        in_repeat[max(0, lo - READ_LEN) : hi + READ_LEN] = True
    return dict(
        codes=codes, repeat_iv=repeat_iv, tandem=tandem, genome=genome_of(), reads=reads,
        truth_snv={(c.first, c.alleles[1]) for c in sim.calls if c.is_snv},
        truth_indel_pos=np.array(sorted(c.first for c in sim.calls if not c.is_snv), np.int64),
        in_repeat=in_repeat,
    )


def lines_digest(lines) -> tuple:
    """(count, sha256 of "\\n".join(lines)) of text lines in output order."""
    import hashlib

    lines = list(lines)
    return len(lines), hashlib.sha256("\n".join(lines).encode()).hexdigest()


def records_digest(records) -> tuple:
    """(count, sha256 of "\\n".join(repr(record_key(r))) in output order)."""
    return lines_digest(repr(record_key(r)) for r in records)


# The digests of what a user reads, each from lines that the package under
# test prints with its own code: a sample's SAM lines ("\t".join of each
# alignment's to_sam_fields(), or a SAM file's @SQ lines and records), a VCF
# body (VCFFileWriter's lines without the header: every sample column of a
# multisample record counts, where record_key reads only the first).
sam_digest = vcf_body_digest = lines_digest


def msa_digest(rows_by_family) -> tuple:
    """(count, sha256) of MSA rows: "<family index>\t<row>" a line, the
    families in msa_families() order, each family's rows in its output
    order."""
    return lines_digest(f"{i}\t{row}" for i, rows in enumerate(rows_by_family) for row in rows)


def imputed_digest(imputed, conf, cols) -> tuple:
    """(cols, sha256 of imputed[:, :cols] as C-order int8, the f64 sum of
    conf[:, :cols]): an imputer's dosages and confidences over its first
    `cols` sites."""
    import hashlib

    d = np.ascontiguousarray(np.asarray(imputed)[:, :cols], dtype=np.int8)
    return (cols, hashlib.sha256(d.tobytes()).hexdigest(),
            float(np.asarray(conf, np.float64)[:, :cols].sum()))


def cnv_digest(calls) -> tuple:
    """(count, sha256) of CNV calls, every field exact: repr of each call's
    fields (dataclasses.asdict) a line."""
    return lines_digest(repr(f) for f in _call_fields(calls))


def sv_fields(variants) -> list:
    """A long-read SV call's fields, as tests/test_torch_long_reads.py
    compares them."""
    return [(v.sequence_name, v.first, v.last, v.length(), tuple(v.alleles),
             v.variant_type, v.var_id, v.quality, v.genotype_quality,
             tuple(v.indexes_called_alleles), v.total_read_depth) for v in variants]


def sv_digest(variants) -> tuple:
    """(count, sha256) of long-read SV calls: repr of sv_fields a line."""
    return lines_digest(repr(f) for f in sv_fields(variants))


def file_lines(path) -> list:
    """A text file's lines without their line ends."""
    with open(path) as fh:
        return [l.rstrip("\n") for l in fh]


def fasta_digest(path) -> tuple:
    """(records, sha256 of the file's lines as lines_digest joins them) of
    a FASTA file as save_fasta writes it."""
    lines = file_lines(path)
    return sum(l.startswith(">") for l in lines), lines_digest(lines)[1]


def gff_body(path) -> list:
    """A GFF file's feature lines without the source column, where each
    package writes its own name, and without the header."""
    return ["\t".join(f[:1] + f[2:])
            for f in (l.split("\t") for l in file_lines(path) if not l.startswith("#"))]


def kmers_digest(prefix) -> tuple:
    """(distinct k-mers, sha256) of KmersExtractor's outputs at `prefix`:
    the _kmers.npz arrays k, codes and counts (name, dtype, shape and bytes
    of each), then the bytes of _kmers_distribution.txt."""
    import hashlib

    h = hashlib.sha256()
    with np.load(prefix + "_kmers.npz") as z:
        for key in ("k", "codes", "counts"):
            a = np.ascontiguousarray(z[key])
            h.update(f"{key}{a.dtype.str}{a.shape}".encode())
            h.update(a.tobytes())
        n = len(z["codes"])
    with open(prefix + "_kmers_distribution.txt", "rb") as fh:
        h.update(fh.read())
    return n, h.hexdigest()


# The JAX package's records on the CPU, as records_digest gives them
# (tests/test_torch_bench_workload.py holds both packages' CPU records to
# them): phase 5's workload (4.6 Mbp, 345,000 reads) and bench.py's (12
# Mbp, 900,000 reads), AlignCallPipeline.run_reads at batch_size 65,536.
PHASE5_RECORDS = (7888, "1623f5c0a4b9f38ba2a572962b8dca1dd32e70aa6267772443bfbf82577d5d3f")
BENCH_SIZE_RECORDS = (20187, "66cdc47ade32ff3a0d4e652c914fc328bd03d6b411ed25515e7c747cd258f0ed")
BENCH_MBP = 12.0
BENCH_N_READS = 900_000
ALL_CNV_ALGORITHMS = "CNVnator,EWT,PoissonHMM,MAXIMUMLIKELIHOOD"
# The JAX package's outputs on the CPU at the sizes of phases 13, 15 and 8
# (tests/test_torch_paths_workload.py holds both packages' CPU outputs to
# them), as sam_digest, vcf_body_digest, cnv_digest and sv_digest give them:
# phase 13's SAM lines of each sample (ReadsAligner.align_batch in
# 32,768-read batches), its VCF body (MultisampleVariantsDetector at
# min_quality 10) and ind2's CNV calls by POP_CNV_RUNS; phase 15's SAM lines
# of every group and its long-read SV calls; phase 8's SAM body (@SQ lines
# and records) and VCF body from the CLI's ReadsAligner and
# SingleSampleVariantsDetector on phase 5's FASTA and FASTQ.
PHASE13_SAM = (
    (183907, "06f392a36f8d89b87ebc7fdee2b58ef494c7098753b23b3c809871c4c30d4626"),
    (183913, "efda3fd03524be715ab4e9f45ea780f60006d6e5b9129f157e4c2a252c12f391"),
    (183921, "c0334131c2b95e96fe176fcd4a979689ae609dd04346ddab6c39547fe5c6a543"),
)
PHASE13_VCF = (23641, "85bd560853bba361be41cfd6f882373b45073d7bb0ae44d5cbba30140f553608")
PHASE13_CNVS = {
    ALL_CNV_ALGORITHMS: (87, "89258d2172c9a7c3674c70267c8657010f17237a28ca276833945c90034058df"),
    "PoissonHMM": (3, "271610983b62389ed54e31d4fc8a79571f9dc2e1b7c0474153fb463b8f944b88"),
    "MAXIMUMLIKELIHOOD": (7, "1e65e3d308008d775f43418121f6c2010e4d22674ae3d1755190b182f02d5205"),
}
PHASE15_SAM = (600, "2658b8d2d3add59a7dc030f3de9a0c9ff96482b0520f346f8f886a148fe30c55")
# phase 15 plants no SV, so its caller makes no call
PHASE15_SVS = (0, "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855")
PHASE8_SAM = (344819, "35d038f90e449c5397809bdb080d772bee0c08e674ab3bad23dc22c3c1a2d2ff")
PHASE8_VCF = (7888, "92538dfac9b599a19d23de1be0ffbf3de445370bbc95e076c0d3b848620e89eb")
# The JAX package's outputs on the CPU at the sizes of phases 10, 23 and 19
# (tests/test_torch_real_size_more.py holds both packages' CPU outputs to
# them): phase 10's records (records_digest; phase 5's inputs with the
# tandem arrays as the known-STR catalogue, run_reads at 65,536); phase 23's
# VCF body (vcf_body_digest of KmerPrefixReadsClusteringAlgorithm.run on
# gbs_inputs' lane) and its MSA rows (msa_digest over msa_families()); phase
# 19's first window (imputed_digest of the imputer's columns [0, 4950),
# which a later window does not overwrite), its confidence sum held within
# PHASE19_CONF_RTOL: a log10 tolerance of FB_POST_TOL on each confidence.
PHASE10_RECORDS = (7897, "11dd2123ab73a896a7ee0247fca369cf359b95f6a4d5d874cf6e4c5ff97cd407")
PHASE23_VCF = (6828, "2c34e8c7a8fecb9dc339728358eb13d25192dd12730ef5e6701ce850c52a0112")
PHASE23_MSA = (293, "91d299acb31bf01e028b94a4118b2f250a0bfa8da0da9148217f6207a5283972")
PHASE19_WINDOW1 = (4950, "d7899a15bfdb702b44f409e3182d5c8bd60d9ff5cf87134b1f519822e0731564", 1394648.1970014584)
# The JAX package's outputs on the CPU at the sizes of phases 17, 21, 11 and
# 24 (tests/test_torch_real_size_rest.py holds both packages' CPU outputs to
# them): phase 17's contigs of the 100 kb row (fasta_digest of save_fasta's
# file); phase 21's GFF bodies without the source column (gff_body), by
# library and de novo, and its orthogroup lines (calculate_orthogroups on the
# catalogs' text, in the CLI runner's line format); phase 11's k-mer maps of
# the reads and of the genome (kmers_digest) and the corrected FASTQ's lines;
# phase 24's records (records_digest).
PHASE17_CONTIGS = (1, "3920268a9b27bd704092fab38ab30c4f9166d89f22c66cd63cf63fdf9407e568")
PHASE21_GFF_LIBRARY = (310, "2658690ccdb588235d1976805f96b6a877519128135b386ab4e6b2a838ad3531")
PHASE21_GFF_DENOVO = (228, "b0f95652ef0d9e7266ed9d78017e68f42dc96a27d81dc638282bf6952e25f536")
PHASE21_ORTHOGROUPS = (1857, "c934f9d55eed00784d6f89cf07950e82212d572531a6e9b8316069096e1caef9")
PHASE11_READS_KMERS = (13098786, "7d7932d5b925cbe0b90524b044e901b73731f5f4de8fc76f0ed704103b9b1516")
PHASE11_GENOME_KMERS = (8915480, "a31c7284a159ab3f8356ee29af07290d3b9ca4c1fe9ada0ab2ee9d19bb4a4cd4")
PHASE11_CORRECTED = (80000, "b855749b5e5ac34b706c4975d75977746714282e677a98ead4386ed563088948")
PHASE24_RECORDS = (7888, "150ce9f552a3f041ae2059053d2f2c1429f70291973c574d8859ea068e56b8b9")


def phase_real_size(counters, device="cuda", mbp=GENOME_MBP, n_reads=N_READS, phase="5",
                    expect=PHASE5_RECORDS):
    """The fused flagship at real size: inputs, index, a warm-up run and a
    timed one, bench.py's gates, the records' digest against `expect`."""
    import torch

    from bench import check_accuracy
    from ngsepcore_tpu_torch.index.minimizer_table import MinimizerTable
    from ngsepcore_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    inp = real_size_inputs(mbp, n_reads)
    genome, reads, tandem = inp["genome"], inp["reads"], inp["tandem"]
    truth_snv, truth_indel_pos, in_repeat = (
        inp["truth_snv"], inp["truth_indel_pos"], inp["in_repeat"])
    L, repeat_iv = genome.total_length, inp["repeat_iv"]
    bases = int(reads.lengths.astype(np.int64).sum())
    repeat_frac = float((repeat_iv[:, 1] - repeat_iv[:, 0]).sum()) / L
    log(f"phase {phase} inputs: {L} bp, repeat fraction {repeat_frac:.4f}, "
        f"{len(reads)} reads, {bases / L:.2f}x, {len(truth_snv)} SNVs, "
        f"{len(truth_indel_pos)} indels ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    table = MinimizerTable.build_from_genome(genome, device=device)
    table.device_arrays(device)
    sync(device)
    log(f"  index on {device}: {len(table.unique_codes)} codes, "
        f"{table.size} entries, {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    _run_pipeline(genome, reads, device, 65536, table=table)
    sync(device)
    log(f"  warm-up run: {time.perf_counter() - t0:.2f}s")

    profiling.enable()
    profiling.reset()
    reset_counts(counters)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe, records = _run_pipeline(genome, reads, device, 65536, table=table)
    sync(device)
    dt = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    profiling.enable(False)
    al = pipe.aligner
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else 0.0
    log(f"  timed run: {dt:.3f}s = {len(reads) / dt:.1f} reads/s; "
        f"{len(records)} records; aligned {al.aligned_reads}, "
        f"tier-3 jobs {al.complete_alns}; launches {launches}; peak {peak:.3f} GiB"
        + (f"; {nvidia_smi()}" if device == "cuda" else ""))
    for name, (total, calls) in sorted(
        profiling._stages.items(), key=lambda kv: -kv[1][0]
    ):
        print(f"  stage {name:<28} {total:9.3f}s x{calls}", flush=True)
    gotoh, walk = counters[0], counters[1]
    by = Counter()
    for (_ends, B, Lq, Ls, kern), n in gotoh.launch_shapes.items():
        by[B, Lq, Ls, kern] += n
    log(f"  Gotoh launches by shape: {shapes_text(by)}")
    log("  walk launches by shape: " + (", ".join(
        f"{n} x {mode} {B}x{Lq}x{Ls} R {R}"
        for (mode, B, Lq, Ls, R, _), n in sorted(walk.launch_shapes.items())) or "none"))
    acc = check_accuracy(records, truth_snv, truth_indel_pos, in_repeat)
    log(f"  accuracy: {json.dumps(acc['metrics'])}")
    fp, fp_near = false_snvs(records, truth_snv, tandem)
    log(f"  false SNV calls: {len(fp)}, of them {fp_near} within 150 bp of a tandem array")
    digest = records_digest(records)
    log(f"  records digest {digest}; the JAX package's on the CPU {expect}")
    if acc["gates"]:
        fail("accuracy gates: " + "; ".join(acc["gates"]))
    if device == "cuda" and min(launches.values()) == 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    if device == "cuda":
        walk_route(counters, "tier3", f"phase {phase}, fused")
    if digest != expect:
        fail(f"phase {phase}: the records {digest} are not the JAX package's {expect}")
    truth = (truth_snv, truth_indel_pos, in_repeat)
    return launches, dt, records, genome, reads, truth, table, tandem, acc["metrics"]


RICE_BP = 373_200_000  # rice, IRGSP-1.0: 373.2 Mbp in 12 pseudomolecules
RICE_SEQS = 12


def rice_sized_genome(chr1, total_bp=RICE_BP, n_seqs=RICE_SEQS, seed=373, classes=None):
    """`chr1` (phase 5's genome) and n_seqs - 1 random sequences of equal
    length (one base more for the first total % (n_seqs - 1)) that fill
    the genome to total_bp, in `classes`' ReferenceGenome (port_classes()
    by default)."""
    k = classes or port_classes()
    rng = np.random.default_rng(seed)
    rest, n = total_bp - len(chr1), n_seqs - 1
    seqs = k.QualifiedSequenceList()
    seqs.add(k.QualifiedSequence(name="chr1", codes=chr1))
    for i in range(n):
        L = rest // n + (i < rest % n)
        seqs.add(k.QualifiedSequence(
            name=f"chr{i + 2}", codes=rng.integers(0, 4, size=L, dtype=np.int8)))
    return k.ReferenceGenome(seqs)


def phase_rice_sized(counters, data5, device="cuda", total_bp=RICE_BP):
    """Phase 5's individual and reads against a rice-sized reference: chr1
    is phase 5's genome, eleven random sequences fill it to 373.2 Mbp.  Its
    table has more than 2^24 distinct codes, so it takes the sorted-key
    layout by its own size; the fused run must pass bench.py's gates (a
    record on a filler sequence counts as a call), launch G, W and S, and
    give the JAX package's CPU records (PHASE24_RECORDS)."""
    import torch

    from bench import check_accuracy
    from ngsepcore_tpu_torch.index.minimizer_table import MinimizerTable
    from ngsepcore_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    _, _, records5, genome5, reads, truth, _, _, _ = data5
    cuda = torch.device(device).type == "cuda"
    genome = rice_sized_genome(genome5.sequences[0].codes, total_bp)
    log(f"phase 24 rice-sized reference: {genome.total_length} bp in "
        f"{genome.num_sequences} sequences ({time.perf_counter() - t_phase:.1f}s)")
    if MinimizerTable.MAX_BUCKETIZED_CODES != SORTED_KEY_SWITCH:
        fail(f"MAX_BUCKETIZED_CODES is {MinimizerTable.MAX_BUCKETIZED_CODES}, "
             f"not the reference's {SORTED_KEY_SWITCH}")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    table = MinimizerTable.build_from_genome(genome, device=device)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    arr = _sorted_key_on(table, device)
    sync(device)
    t_layout = time.perf_counter() - t0
    n_codes = len(table.unique_codes)
    culled = n_codes - arr.keys.shape[0]
    nbytes = sum(x.numel() * x.element_size() for x in arr)
    peak_build = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    log(f"  index on {device}: {n_codes} codes (switch {SORTED_KEY_SWITCH}), {culled} "
        f"culled ({culled / max(1, n_codes):.4%}), {table.size} entries "
        f"({arr.entry_packed.shape[0]} kept); build_from_genome {t_build:.2f}s, "
        f"sorted-key layout {t_layout:.2f}s; table {nbytes} bytes on the device; "
        f"peak {peak_build:.3f} GiB")
    if n_codes <= SORTED_KEY_SWITCH:
        fail(f"the rice-sized table has {n_codes} codes, not more than {SORTED_KEY_SWITCH}")

    t0 = time.perf_counter()
    _run_pipeline(genome, reads, device, 65536, table=table)
    sync(device)
    log(f"  warm-up run: {time.perf_counter() - t0:.2f}s")
    profiling.enable()
    profiling.reset()
    reset_counts(counters)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe, records = _run_pipeline(genome, reads, device, 65536, table=table)
    sync(device)
    dt = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    profiling.enable(False)
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    al = pipe.aligner
    log(f"  timed run: {dt:.3f}s = {len(reads) / dt:.1f} reads/s; {len(records)} records; "
        f"aligned {al.aligned_reads}, tier-3 jobs {al.complete_alns}; launches {launches}; "
        f"peak {peak:.3f} GiB")
    for name, (total, calls) in sorted(
        profiling._stages.items(), key=lambda kv: -kv[1][0]
    ):
        print(f"  stage {name:<28} {total:9.3f}s x{calls}", flush=True)
    k24 = {record_key(r) for r in records}
    k5 = {record_key(r) for r in records5}
    off_chr1 = sum(r.variant.sequence_name != "chr1" for r in records)
    acc = check_accuracy(records, *truth)
    digest = records_digest(records)
    log(f"  accuracy: {json.dumps(acc['metrics'])}; records differing from phase 5's: "
        f"{len(k24 - k5)} only here, {len(k5 - k24)} only there; {off_chr1} on the "
        f"filler sequences; records digest {digest}, the JAX package's on the CPU "
        f"{PHASE24_RECORDS}; phase {time.perf_counter() - t_phase:.1f}s")
    if acc["gates"]:
        fail("phase 24 accuracy gates: " + "; ".join(acc["gates"]))
    if digest != PHASE24_RECORDS:
        fail(f"phase 24: the records {digest} are not the JAX package's {PHASE24_RECORDS}")
    if cuda and min(launches.values()) == 0:
        fail(f"a kernel was not launched on the rice-sized run: {launches}")
    if cuda:
        walk_route(counters, "tier3", "phase 24, fused")
    return launches


# phase 25 meshes on one card: D = 4 twice, since a missed wait between
# streams gives wrong records only some of the time
MESH_SHARDS = (1, 2, 4, 4)
# relative tolerances of tests/test_torch_distribute.py: the span kernel's
# float64 products summed in other orders; posteriors, 10^x on each side
MESH_FLOAT_RTOL = 1e-9
MESH_POST_RTOL = 1e-12


def _sharded_pipeline(genome, devices, batch_size, table=None):
    from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner
    from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector
    from ngsepcore_tpu_torch.distribute import make_reads_mesh
    from ngsepcore_tpu_torch.distribute.pipeline import ShardedAlignCallPipeline

    mesh = make_reads_mesh(devices=devices)
    return ShardedAlignCallPipeline(
        genome, aligner=ReadsAligner(genome, table=table, device=mesh.lead),
        detector=SingleSampleVariantsDetector(genome, sample_id="s1", device=mesh.lead),
        batch_size=batch_size, mesh=mesh,
    )


def _first_calls(pipe):
    """[args, kw] of the first window's sharded span kernel call and of
    the first tier-3 sweep, filled in as the pipeline runs."""
    firsts = {}

    def spy(name, fn):
        def f(*args, **kw):
            firsts.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return f

    pipe._span_kernel = spy("span", pipe._span_kernel)
    pipe.aligner.dp_run_all_fn = spy("dp", pipe.aligner.dp_run_all_fn)
    return firsts


def _on_cpu(x):
    import torch

    return x.cpu() if isinstance(x, torch.Tensor) else x


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not a.size:
        return 0.0
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _call_step_inputs(rng, B=2048, L=160, W=1 << 16, read_len=150):
    """sharded_call_step's inputs at the fused path's widths: reads of 150
    bp copied from a random genome with 1% substitutions, subjects the
    genome at the same start, qualities 2-40, window offsets the starts."""
    g = rng.integers(0, 4, W + L).astype(np.int8)
    pos = rng.integers(0, W - read_len, B)
    idx = pos[:, None] + np.arange(L)[None, :]
    subjects = g[idx]
    reads = subjects.copy()
    sub = rng.random((B, L)) < 0.01
    reads[sub] = (reads[sub] + 1) % 4
    reads[:, read_len:] = 4
    quals = rng.integers(2, 41, (B, L)).astype(np.int8)
    return (reads, np.full(B, read_len, np.int32), subjects, np.full(B, L, np.int32),
            quals, pos.astype(np.int32)), W


def phase_mesh_50kb(counters, keys4=None, device="cuda"):
    """Phase 25 (a): ShardedAlignCallPipeline on ["cuda:0"] * 2 against
    ["cpu"] * 2 on phase 4's 50 kb input, records equal to each other and to
    phase 4's unsharded CUDA ones; the CUDA run's first window through the
    sharded span kernel and its first tier-3 group through the sharded
    sweep (in 4 times as many chunks, so both shards work) on both meshes;
    sharded_call_step at two shards on both.  (device="cpu" rehearses the
    phase on the CPU alone.)"""
    import torch

    from ngsepcore_tpu_torch.distribute import make_reads_mesh, sharded_call_step
    from ngsepcore_tpu_torch.distribute.pipeline import (
        make_sharded_dp_run_all,
        make_sharded_span_kernel,
    )
    from ngsepcore_tpu_torch.kernels.genotyping import (
        genotype_window_hist_resolve_batch,
        snv_contribution_table,
    )

    t_phase = time.perf_counter()
    if device == "cuda":
        try:
            make_reads_mesh(torch.cuda.device_count() + 1, device="cuda")
        except RuntimeError:
            pass  # a mesh of more cards than the machine has raises
        else:
            fail("a mesh of more CUDA devices than visible did not raise")
    genome, reads = _simulate_50kb()
    if keys4 is None:
        _, rec4 = _run_pipeline(genome, reads, device, 1024)
        keys4 = [record_key(r) for r in rec4]
    card = device + (":0" if device == "cuda" else "")
    keys, firsts = [], None
    for devices in ([card] * 2, ["cpu"] * 2):
        pipe = _sharded_pipeline(genome, devices, 1024)
        calls = _first_calls(pipe)
        reset_counts(counters)
        t0 = time.perf_counter()
        with plain_post_pass_forbidden(devices[0].split(":")[0]):
            recs = pipe.run_reads(reads)
        sync(devices[0])
        keys.append([record_key(r) for r in recs])
        log(f"phase 25 50 kb on {devices}: {len(recs)} records "
            f"({time.perf_counter() - t0:.2f}s), launches by shard "
            f"{[dict(c) for c in pipe.mesh.launches]}, host syncs in shards "
            f"{pipe.mesh.host_syncs}")
        if firsts is None:
            firsts = calls
            if device == "cuda":
                # a group here has one or two chunks, so a shard may get none
                walk_route(counters, "tier3", "phase 25 50 kb")
                if not sum(c["gotoh_forward"] for c in pipe.mesh.launches):
                    fail("the sharded 50 kb run launched no Gotoh kernel in a shard")
    if len(keys[0]) <= 10 or not keys[0] == keys[1] == keys4:
        fail("phase 25: sharded CUDA, sharded CPU and phase 4's unsharded records differ")
    if set(firsts) != {"span", "dp"}:
        fail(f"the sharded CUDA run missed a sharded function: {sorted(firsts)}")

    # the CUDA run's inputs on a CUDA mesh and, copied, on a CPU mesh
    meshes = [make_reads_mesh(devices=d) for d in ([card] * 2, ["cpu"] * 2)]
    both = lambda a: (a, [_on_cpu(x) for x in a])
    args, kw = firsts["span"]
    got = genotype_window_hist_resolve_batch([
        make_sharded_span_kernel(m)(*a, **kw) for m, a in zip(meshes, both(args))
    ])
    ints = ("site_idx", "bi", "bj", "gq", "depths", "total", "strand_counts")
    span_err = max(_max_rel(got[0][f], got[1][f]) for f in ("ref_prob", "logcond"))
    if (got[0]["n_sites"] != got[1]["n_sites"] or got[0]["n_flagged"] != got[1]["n_flagged"]
            or any(not np.array_equal(got[0][f], got[1][f]) for f in ints)
            or span_err > MESH_FLOAT_RTOL):
        fail(f"phase 25: the sharded span kernel differs, CUDA against CPU (float rel {span_err})")
    args, kw = firsts["dp"]
    kw = dict(kw, CH=kw["CH"] // 4, n_chunks=kw["n_chunks"] * 4)
    dp = [make_sharded_dp_run_all(m)(*a, **kw) for m, a in zip(meshes, both(args))]
    if any(not torch.equal(dp[0][k].cpu(), dp[1][k]) for k in dp[1]):
        fail("phase 25: the sharded tier-3 sweep differs, CUDA against CPU")
    step_args, W = _call_step_inputs(np.random.default_rng(25))
    C = snv_contribution_table()
    st = [[_on_cpu(x) for x in sharded_call_step(m, W, C)(*step_args)] for m in meshes]
    post_err = _max_rel(st[0][3], st[1][3])
    if (any(not torch.equal(st[0][i], st[1][i]) for i in range(3))
            or post_err > MESH_POST_RTOL):
        fail(f"phase 25: sharded_call_step differs, CUDA against CPU (posteriors rel {post_err})")
    log(f"  span kernel on window 1: {got[0]['n_sites']} sites, {got[0]['n_flagged']} flagged, "
        f"float rel {span_err:.3g}; tier-3 sweep {kw['n_chunks']} x {kw['CH']} rows equal; "
        f"sharded_call_step {len(step_args[0])} reads, counts {int(st[0][2].sum())}, "
        f"posteriors rel {post_err:.3g} (tolerance {MESH_POST_RTOL}); "
        f"phase 25 (a) {time.perf_counter() - t_phase:.1f}s")


def phase_mesh_real_size(counters, data5, smi: str, device="cuda"):
    """Phase 25 (b): phase 5's genome, reads and index through
    ShardedAlignCallPipeline on ["cuda:0"] * D for D in MESH_SHARDS: records
    identical at every D and to phase 5's unsharded ones, bench.py's gates,
    every walk in the tier3 mode, no shear-histogram launch (the mesh
    genotypes on the span path), every shard launching the Gotoh kernel
    and the walk.  Prints wall, stage seconds, launches and host syncs by
    shard and peak memory for each D.  Returns the first D = 4 run's
    launches, for the kernels line.  (device="cpu" rehearses the phase.)"""
    import torch

    from bench import check_accuracy
    from ngsepcore_tpu_torch.utils import profiling

    _, _, records5, genome, reads, truth, table, _, _ = data5
    keys5 = [record_key(r) for r in records5]
    cuda = device == "cuda"
    card = device + (":0" if cuda else "")
    out, keys = None, []
    for D in MESH_SHARDS:
        pipe = _sharded_pipeline(genome, [card] * D, 65536, table=table)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        profiling.enable()
        profiling.reset()
        reset_counts(counters)
        t0 = time.perf_counter()
        recs = pipe.run_reads(reads)
        sync(device)
        dt = time.perf_counter() - t0
        profiling.enable(False)
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
        launches = {c.__name__: c.launches for c in counters}
        mesh = pipe.mesh
        stages = {k: profiling._stages.get(k, [0.0, 0])[0] for k in (
            "align.seed_dispatch", "align.tier3_dispatch", "call.window_dispatch")}
        acc = check_accuracy(recs, *truth)
        keys.append([record_key(r) for r in recs])
        log(f"phase 25 {genome.total_length} bp, {len(reads)} reads on {card} x {D} ({smi}): "
            f"{dt:.3f}s = {len(reads) / dt:.1f} reads/s; {len(recs)} records; stages "
            + ", ".join(f"{k} {v:.3f}s" for k, v in stages.items())
            + f"; launches by shard {[dict(c) for c in mesh.launches]}; host syncs in shards "
            f"{mesh.host_syncs}; peak {peak:.3f} GiB; accuracy {json.dumps(acc['metrics'])}")
        if cuda:
            walk_route(counters, "tier3", f"phase 25, D = {D}")
        if launches["shear_hist"]:
            fail(f"phase 25, D = {D}: the mesh took the histogram genotyper")
        by_shard = {k: sum(c[k] for c in mesh.launches) for k in ("gotoh_forward", "run_walk")}
        if cuda and (by_shard != {"gotoh_forward": launches["gotoh_forward_plane"],
                                  "run_walk": launches["_runs_from_plane"]}
                     or not all(c["gotoh_forward"] and c["run_walk"] for c in mesh.launches)):
            fail(f"phase 25, D = {D}: launches {launches}, by shard {mesh.launches}: every "
                 "launch should come from a shard, and every shard should launch")
        if acc["gates"]:
            fail(f"phase 25, D = {D}: accuracy gates: " + "; ".join(acc["gates"]))
        if D == 4 and out is None:
            out = {"gotoh_forward_plane": launches["gotoh_forward_plane"],
                   "_runs_from_plane": launches["_runs_from_plane"],
                   "by_shard": [dict(c) for c in mesh.launches]}
        del pipe
    if any(k != keys5 for k in keys):
        diff = [len(set(k) ^ set(keys5)) for k in keys]
        fail(f"phase 25: sharded records differ from phase 5's (symmetric differences {diff})")
    return out


def phase_mesh(counters, data5, keys4, smi: str):
    phase_mesh_50kb(counters, keys4)
    return phase_mesh_real_size(counters, data5, smi)


# ---------------------------------------------------------------------------
def _run_classic(genome, reads, device):
    """ReadsAligner.align_batch in 1024-read batches, then
    SingleSampleVariantsDetector.find_variants: (SAM lines, records)."""
    from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner
    from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector

    aligner = ReadsAligner(genome, device=device)
    alns = []
    for i in range(0, len(reads), 1024):
        for per_read in aligner.align_batch(reads[i : i + 1024]):
            alns.extend(per_read)
    sam = ["\t".join(a.to_sam_fields()) for a in alns]
    det = SingleSampleVariantsDetector(genome, sample_id="s1", device=device)
    return sam, det.find_variants(alns), aligner


def phase_classic(counters, fused_keys):
    genome, reads = _simulate_50kb()
    reset_counts(counters)
    t0 = time.perf_counter()
    with plain_post_pass_forbidden():
        sam_cuda, rec_cuda, al = _run_classic(genome, reads, "cuda")
    sync("cuda")
    t_cuda = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    walk_route(counters, "tier3", "phase 6, classic")
    t0 = time.perf_counter()
    sam_cpu, rec_cpu, _ = _run_classic(genome, reads, "cpu")
    t_cpu = time.perf_counter() - t0
    kc = [record_key(r) for r in rec_cuda]
    kp = [record_key(r) for r in rec_cpu]
    n_sam_diff = sum(a != b for a, b in zip(sam_cuda, sam_cpu))
    log(f"phase 6 classic 50 kb: {len(sam_cuda)} SAM lines, {len(kc)} records "
        f"on CUDA ({t_cuda:.2f}s), {len(kp)} on CPU ({t_cpu:.2f}s); "
        f"SAM lines differing {n_sam_diff}; tier-3 jobs {al.complete_alns}; "
        f"launches {launches}")
    if len(sam_cuda) != len(sam_cpu) or n_sam_diff:
        fail("classic CUDA and CPU SAM lines differ")
    if len(kc) <= 10 or kc != kp:
        fail("classic CUDA and CPU records differ")
    if kc != fused_keys:
        fail("classic records differ from the fused records of phase 4")
    if launches["gotoh_forward_plane"] == 0:
        fail(f"the classic tier-3 did not launch the Gotoh kernel: {launches}")
    return launches


def phase_span(counters):
    """The 50 kb reads with qualities redrawn over all 42 Phred values:
    31 levels after the 0..30 clamp, so the fused pipeline genotypes
    through the span-scatter path."""
    from ngsepcore_tpu_torch.core.sequences import RawRead

    genome, reads = _simulate_50kb()
    rng = np.random.default_rng(41)
    reads = [
        RawRead(
            name=r.name, sequence=r.sequence,
            qualities=(rng.integers(0, 42, len(r.sequence)) + 33)
            .astype(np.uint8).tobytes().decode("ascii"),
        )
        for r in reads
    ]
    keys = {}
    for device in ("cuda", "cpu"):
        pipe = _make_pipeline(genome, device, 1024)
        took = []
        span = pipe._genotype_span
        pipe._genotype_span = lambda *a, _s=span: took.append(1) or _s(*a)
        reset_counts(counters)
        t0 = time.perf_counter()
        recs = pipe.run_reads(reads)
        sync(device)
        dt = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        if took != [1]:
            fail(f"the {device} run did not take the span genotyper")
        keys[device] = [record_key(r) for r in recs]
        log(f"phase 7 span genotyper 50 kb, 31 quality levels, {device}: "
            f"{len(recs)} records ({dt:.2f}s), launches {launches}")
    if len(keys["cuda"]) <= 10 or keys["cuda"] != keys["cpu"]:
        fail("span-path CUDA and CPU records differ")


def _write_inputs(d, genome, reads):
    """FASTA of the genome and FASTQ of the reads (the block's default
    quality where it carries none)."""
    from ngsepcore_tpu_torch.io.fasta import save_fasta
    from ngsepcore_tpu_torch.io.fastq import write_fastq

    save_fasta(genome.sequences, os.path.join(d, "genome.fa"))
    write_fastq(reads, os.path.join(d, "reads.fastq"))


def _cli(args, timeout):
    """Run the port's CLI on the card in a subprocess with --profile;
    returns (seconds, stage-profile lines)."""
    cmd = [sys.executable, "-m", "ngsepcore_tpu_torch", "--device", "cuda",
           "--profile"] + args
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    if out.returncode != 0:
        print(out.stderr[-4000:], flush=True)
        fail(f"CLI {args[0]} exited {out.returncode}")
    err = out.stderr.splitlines()
    prof = err[err.index("stage profile (wall-clock)"):] if (
        "stage profile (wall-clock)" in err) else []
    summary = [l for l in err if l.startswith(("Reads:", "Called", "kernel launches"))]
    return dt, [l for l in prof if l.startswith("  ")], summary


def sam_file_body(path) -> list:
    """A SAM file's @SQ lines and records (@HD, @RG and @PG, which names the
    package, left out), without their line ends."""
    with open(path) as fh:
        return [l.rstrip("\n") for l in fh if l.startswith("@SQ") or not l.startswith("@")]


def vcf_file_body(path) -> list:
    """A VCF file's lines without the header, without their line ends."""
    with open(path) as fh:
        return [l.rstrip("\n") for l in fh if not l.startswith("#")]


def phase_cli(d, genome, reads, truth, fused_records):
    """The classic CLI on phase 5's data; `d` is a scratch directory that
    keeps genome.fa and reads.fastq for the phases after this one.  The SAM
    and VCF bodies are held to the JAX CLI's CPU digests (PHASE8_*)."""
    from bench import check_accuracy
    from ngsepcore_tpu_torch.vcf.io import VCFFileReader

    t0 = time.perf_counter()
    _write_inputs(d, genome, reads)
    log(f"phase 8 CLI inputs: {len(reads)} reads -> FASTQ "
        f"({time.perf_counter() - t0:.1f}s)")
    g, fq = os.path.join(d, "genome.fa"), os.path.join(d, "reads.fastq")
    sam, vcf = os.path.join(d, "alns.sam"), os.path.join(d, "calls")
    t_al, prof_al, sum_al = _cli(
        ["ReadsAligner", "-r", g, "-o", sam, "-s", "s1", fq], 900)
    log(f"  ReadsAligner: {t_al:.3f}s = {len(reads) / t_al:.1f} reads/s "
        f"(process wall, start-up included); {'; '.join(sum_al)}")
    for line in prof_al:
        print(f"  align {line.strip()}", flush=True)
    t_vc, prof_vc, sum_vc = _cli(
        ["SingleSampleVariantsDetector", "-r", g, "-i", sam, "-o", vcf,
         "-sampleId", "s1"], 900)
    log(f"  SingleSampleVariantsDetector: {t_vc:.3f}s; {'; '.join(sum_vc)}")
    for line in prof_vc:
        print(f"  call {line.strip()}", flush=True)
    log(f"  classic CLI total {t_al + t_vc:.3f}s = "
        f"{len(reads) / (t_al + t_vc):.1f} reads/s")
    cli_lines = vcf_file_body(vcf + ".vcf")
    digests = {"sam": sam_digest(sam_file_body(sam)), "vcf": vcf_body_digest(cli_lines)}
    log(f"  phase 8 digests: {json.dumps(digests)}")
    if digests != {"sam": PHASE8_SAM, "vcf": PHASE8_VCF}:
        fail(f"phase 8's SAM or VCF body digest is not the JAX CLI's {PHASE8_SAM}, "
             f"{PHASE8_VCF}")
    records = VCFFileReader(vcf + ".vcf").load_all()
    fused_lines = _vcf_body(fused_records, ["s1"])
    n_diff = len(set(cli_lines) ^ set(fused_lines))
    log(f"  {len(records)} records; differing from phase 5's fused "
        f"records: {n_diff} (of {len(cli_lines)} and {len(fused_lines)})")
    # the JAX package's CLI and fused VCF bodies are equal at this size
    if n_diff:
        fail(f"the CLI's VCF body differs from phase 5's fused records in {n_diff} lines")
    acc = check_accuracy(records, *truth)
    log(f"  accuracy: {json.dumps(acc['metrics'])}")
    if acc["gates"]:
        fail("CLI accuracy gates: " + "; ".join(acc["gates"]))
    return t_al, t_vc


# ---------------------------------------------------------------------------
LONG_STR = (47_000, 48_500)  # phase 9's long tandem array, 0-based half-open


def _simulate_str_50kb(seed: int = 31):
    """A 50 kb genome with 14 planted tandem arrays (motifs of 2-6 bp, 8-20
    copies) and one long array of 1,500 bp (375 copies of a 4 bp motif at
    LONG_STR), an individual whose arrays differ from the reference by one
    or two whole units (homozygous; three for the long one) and that
    carries a few SNVs, and 6,300 reads of 100 bp with 0.4% substitutions:
    3,000 placed to straddle a short array, 300 an edge of the long one.
    A flank window over the long array is 1,504-1,600 columns wide, so
    tier 2 takes the seg Gotoh kernel with 6-8 warps an alignment there.
    Returns (genome, reads, catalogue)."""
    from ngsepcore_tpu_torch.core.genome import ReferenceGenome
    from ngsepcore_tpu_torch.core.sequences import (
        QualifiedSequence,
        QualifiedSequenceList,
        RawRead,
        decode_dna,
    )

    rng = np.random.default_rng(seed)
    L = 50_000
    codes = rng.integers(0, 4, size=L).astype(np.int8)
    arrays = []
    for a in range(14):
        mlen = int(rng.integers(2, 7))
        unit = rng.integers(0, 4, size=mlen).astype(np.int8)
        while len(set(unit.tolist())) == 1:
            unit = rng.integers(0, 4, size=mlen).astype(np.int8)
        ncopies = int(rng.integers(8, 21))
        dst = 2000 + a * 3300 + int(rng.integers(0, 500))
        codes[dst : dst + mlen * ncopies] = np.tile(unit, ncopies)
        arrays.append((dst, dst + mlen * ncopies, unit))
    long_lo, long_hi = LONG_STR
    long_unit = np.array([0, 2, 1, 3], np.int8)
    codes[long_lo:long_hi] = np.tile(long_unit, (long_hi - long_lo) // 4)
    # the individual, built right to left so that coordinates stay valid
    ind = codes.copy()
    snv = rng.choice(L, size=60, replace=False)
    ind[snv] = (ind[snv] + rng.integers(1, 4, size=60)) % 4
    ind = np.concatenate([ind[:long_lo], np.tile(long_unit, (long_hi - long_lo) // 4 + 3),
                          ind[long_hi:]])
    centres = []
    for lo, hi, unit in reversed(arrays):
        delta = int(rng.choice([-2, -1, 1, 2]))
        ncopies = (hi - lo) // len(unit) + delta
        ind = np.concatenate([ind[:lo], np.tile(unit, ncopies), ind[hi:]])
        centres.append((lo + hi) // 2)
    starts = [int(rng.integers(0, len(ind) - 100)) for _ in range(3000)]
    starts += [max(0, min(len(ind) - 100, int(c + rng.integers(-110, 10))))
               for c in rng.choice(centres, size=3000)]
    # reads over the long array's two edges (it moved with the short
    # arrays' length changes, all of them to its left)
    lo_ind = long_lo + len(ind) - L - 12
    hi_ind = lo_ind + (long_hi - long_lo) + 12
    lrng = np.random.default_rng(seed + 1)
    starts += [int(e + lrng.integers(-90, -10)) for e in [lo_ind] * 150 + [hi_ind] * 150]
    reads = []
    for i, st in enumerate(starts):
        rc = ind[st : st + 100].copy()
        err = rng.random(100) < 0.004
        rc[err] = (rc[err] + rng.integers(1, 4, size=int(err.sum()))) % 4
        if rng.random() < 0.5:
            rc = (3 - rc[::-1]).astype(np.int8)
        reads.append(RawRead(name=f"r_{i}", sequence=decode_dna(rc), qualities="F" * 100))
    seqs = QualifiedSequenceList()
    seqs.add(QualifiedSequence(name="chrS", codes=codes))
    return ReferenceGenome(seqs), reads, str_catalogue(
        "chrS", sorted([a[:2] for a in arrays] + [LONG_STR]))


def _run_str(genome, reads, strs, device, mark=lambda: 0):
    """Classic then fused with a known-STR catalogue: (SAM lines, classic
    record keys, fused record keys, tier-2 candidate cells of each flow,
    what mark() counted in each flow: it is called before and after
    each)."""
    from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner
    from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector

    marks = [mark()]
    aligner = ReadsAligner(genome, known_strs=strs, device=device)
    alns = []
    for i in range(0, len(reads), 1024):
        for per_read in aligner.align_batch(reads[i : i + 1024]):
            alns.extend(per_read)
    sam = ["\t".join(a.to_sam_fields()) for a in alns]
    det = SingleSampleVariantsDetector(genome, sample_id="s1", device=device)
    det.known_strs = strs
    classic = [record_key(r) for r in det.find_variants(alns)]
    marks.append(mark())
    pipe = _make_pipeline(genome, device, 1024, table=aligner.table, known_strs=strs)
    fused = [record_key(r) for r in pipe.run_reads(reads)]
    marks.append(mark())
    return (sam, classic, fused, aligner.tier2_reads, pipe.aligner.tier2_reads,
            (marks[1] - marks[0], marks[2] - marks[1]))


def _seg_over_long_str(gotoh) -> int:
    """Gotoh launches since the last reset_counts that the seg kernel took
    at subjects wider than 1,024 columns: phase 9's flanks over its long
    array."""
    return sum(n for (_, _, _, Ls, kern), n in gotoh.launch_shapes.items()
               if kern == "seg" and Ls > 1024)


def _known_str_cli(pool, d, genome, sam, strs):
    """Write phase 9's genome, SAM lines and catalogue to `d` and start
    SingleSampleVariantsDetector -knownSTRs through the CLI on the card and
    on the CPU in `pool`, in the background: (futures by device, VCF path
    by device)."""
    from ngsepcore_tpu_torch.io.fasta import save_fasta
    from ngsepcore_tpu_torch.io.sam import ReadAlignmentFileWriter

    g, alns, cat = (os.path.join(d, f) for f in ("genome.fa", "s1.sam", "strs.txt"))
    save_fasta(genome.sequences, g)
    with open(alns, "w") as fh:
        ReadAlignmentFileWriter(genome.sequences, fh, sample_id="s1")
        fh.write("".join(line + "\n" for line in sam))
    with open(cat, "w") as fh:
        fh.write("".join(f"{r.sequence_name}\t{r.first}\t{r.last}\n"
                         for regions in strs.values() for r in regions))
    out = {dev: os.path.join(d, f"calls_{dev}") for dev in ("cuda", "cpu")}
    runs = {dev: pool.submit(
        _cli_plain, ["SingleSampleVariantsDetector", "-r", g, "-i", alns, "-o", out[dev],
                     "-sampleId", "s1", "-knownSTRs", cat], dev, 900,
        3 if dev == "cpu" else None) for dev in out}
    return runs, {dev: p + ".vcf" for dev, p in out.items()}


def _str_50kb_cpu():
    """Phase 9's CPU side, in a process of its own: both known-STR flows on
    the CPU with two torch threads; (SAM lines, classic record keys, fused
    record keys, seconds)."""
    import torch

    torch.set_num_threads(2)
    genome, reads, strs = _simulate_str_50kb()
    t0 = time.perf_counter()
    sam, classic, fused, _, _, _ = _run_str(genome, reads, strs, "cpu")
    return sam, classic, fused, time.perf_counter() - t0


class _InBackground:
    """fn() in a spawned process of its own, started at once; result()
    waits for it, failing the run on an error or after `timeout` seconds.
    The process ends with result() or at exit."""

    def __init__(self, fn, timeout=1200):
        import atexit
        import multiprocessing

        self.pool = multiprocessing.get_context("spawn").Pool(1)
        atexit.register(self.pool.terminate)
        self.job = self.pool.apply_async(fn)
        self.timeout = timeout

    def result(self, where):
        try:
            return self.job.get(self.timeout)
        except Exception as e:
            fail(f"{where}: its background job failed: {e!r}")
        finally:
            self.pool.terminate()


def phase_str_50kb(counters):
    """Known STRs at 50 kb, CUDA against CPU: the classic and fused flows
    in process, then SingleSampleVariantsDetector -knownSTRs through the
    CLI on the CUDA run's alignments (the CPU side in the background).
    The in-process CPU flows run in a background process while later
    phases run: returns (the seg-kernel launches over the long array, a
    function that waits for the CPU flows and holds them against CUDA's)."""
    from concurrent.futures import ThreadPoolExecutor

    cpu = _InBackground(_str_50kb_cpu)
    genome, reads, strs = _simulate_str_50kb()
    gotoh = counters[0]
    reset_counts(counters)
    t0 = time.perf_counter()
    sam_c, cl_c, fu_c, t2_classic, t2_fused, seg_flows = _run_str(
        genome, reads, strs, "cuda", mark=lambda: _seg_over_long_str(gotoh))
    sync("cuda")
    t_cuda = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    shapes = tier2_shapes(gotoh)
    t2 = tier2_launches(shapes)
    with tempfile.TemporaryDirectory() as d, ThreadPoolExecutor(2) as pool:
        cli, vcf = _known_str_cli(pool, d, genome, sam_c, strs)
        t_cli = {dev: run.result()[0] for dev, run in cli.items()}
        body = {dev: [l for l in open(p) if not l.startswith("#")] for dev, p in vcf.items()}
    n_indel = sum(len(k[2][0]) != len(k[2][1]) for k in fu_c)
    log(f"phase 9 known STRs 50 kb, {len(strs['chrS'])} arrays: {len(sam_c)} SAM "
        f"lines, {len(cl_c)} classic and {len(fu_c)} fused records ({n_indel} indels) "
        f"on CUDA ({t_cuda:.2f}s); tier-2 cells classic {t2_classic}, fused {t2_fused}; "
        f"launches {launches}, of them tier-2 flanks {t2}")
    for side, by in shapes.items():
        log(f"  tier-2 {side} flank launches: {shapes_text(by)}")
    n_cli_diff = len(set(body["cuda"]) ^ set(body["cpu"]))
    log(f"  CLI SingleSampleVariantsDetector -knownSTRs: {len(body['cuda'])} records on "
        f"CUDA ({t_cli['cuda']:.2f}s), {len(body['cpu'])} on the CPU ({t_cli['cpu']:.2f}s, "
        f"in the background), differing {n_cli_diff}; in process {len(cl_c)}")
    if len(fu_c) <= 10 or cl_c != fu_c:
        fail("known-STR classic and fused records differ")
    if len(body["cuda"]) <= 10 or body["cuda"] != body["cpu"]:
        fail("the known-STR CLI detector's CUDA and CPU VCF records differ")
    if n_indel < 5 or not any(("I" in l.split("\t")[5] or "D" in l.split("\t")[5])
                              for l in sam_c):
        fail("the repeat-length differences were not called")
    if min(t2_classic, t2_fused) == 0 or min(t2.values()) == 0:
        fail(f"the tier-2 flanks did not launch the Gotoh kernel: {t2}")
    long_reads = {f"r_{i}" for i in range(6000, 6300)}
    split = sum(_split_at_long_str(line) for line in sam_c
                if line.split("\t", 1)[0] in long_reads)
    log(f"  seg-kernel launches over the long array (Ls > 1024): classic {seg_flows[0]}, "
        f"fused {seg_flows[1]}; reads over the long array's edges split around it "
        f"{split} of {len(long_reads)}")
    if min(seg_flows) < 2:
        fail(f"tier 2 did not launch the seg Gotoh kernel twice in each flow over the "
             f"long array: {seg_flows}")
    if split < len(long_reads) // 2:
        fail("fewer than half of the reads over the long array were split around it")

    def finish():
        sam_p, cl_p, fu_p, t_cpu = cpu.result("phase 9")
        n_sam_diff = sum(a != b for a, b in zip(sam_c, sam_p))
        log(f"phase 9 known STRs 50 kb on the CPU (in the background, {t_cpu:.2f}s): "
            f"{len(sam_p)} SAM lines (differing from CUDA's {n_sam_diff}), "
            f"{len(cl_p)} classic and {len(fu_p)} fused records")
        if len(sam_c) != len(sam_p) or n_sam_diff:
            fail("known-STR classic CUDA and CPU SAM lines differ")
        if fu_c != fu_p or cl_c != cl_p:
            fail("known-STR CUDA and CPU records differ")

    return sum(seg_flows), finish


def _split_at_long_str(sam_line) -> bool:
    """True where a SAM line's alignment stops at the long array's left
    edge with a clipped tail, or starts right after its right edge with a
    clipped head: the tier-2 split around the array."""
    f = sam_line.split("\t")
    cigar = [(int(n), op) for n, op in re.findall(r"(\d+)([MIDNSHP=X])", f[5])]
    first = int(f[3])
    last = first - 1 + sum(n for n, op in cigar if op in "MDN=X")
    lo, hi = LONG_STR
    return ((last == lo and cigar and cigar[-1][1] == "S")
            or (first == hi + 1 and cigar and cigar[0][1] == "S"))


def phase_str_real_size(counters, genome, reads, truth, table, tandem, metrics5,
                        device="cuda"):
    """Phase 5's genome and reads with its tandem arrays as the known-STR
    catalogue, through AlignCallPipeline.run_reads; the records' digest
    against the JAX package's (PHASE10_RECORDS)."""
    from bench import check_accuracy
    from ngsepcore_tpu_torch.utils import profiling

    strs = str_catalogue("chr1", tandem)
    pipe = _make_pipeline(genome, device, 65536, table=table, known_strs=strs)
    profiling.enable()
    profiling.reset()
    reset_counts(counters)
    t0 = time.perf_counter()
    records = pipe.run_reads(reads)
    sync(device)
    dt = time.perf_counter() - t0
    profiling.enable(False)
    launches = {c.__name__: c.launches for c in counters}
    shapes = tier2_shapes(counters[0])
    t2 = tier2_launches(shapes)
    t2_walk = tier2_walk_launches(counters[1])
    al = pipe.aligner
    log(f"phase 10 known STRs at {GENOME_MBP} Mbp, {len(strs['chr1'])} arrays "
        f"({len(tandem)} planted): {dt:.3f}s = {len(reads) / dt:.1f} reads/s (first "
        f"run with the catalogue); {len(records)} records; tier-2 cells "
        f"{al.tier2_reads}; "
        f"tier-3 jobs {al.complete_alns}; launches {launches}, of them tier-2 "
        f"flanks {t2} (Gotoh), {t2_walk} (walk)")
    for side, by in shapes.items():
        log(f"  tier-2 {side} flank launches: {shapes_text(by)}")
    for name, (total, calls) in sorted(
        profiling._stages.items(), key=lambda kv: -kv[1][0]
    ):
        print(f"  stage {name:<28} {total:9.3f}s x{calls}", flush=True)
    acc = check_accuracy(records, *truth)
    log(f"  accuracy: {json.dumps(acc['metrics'])}")
    for k in ("indel_recall", "indel_recall_unique", "indel_precision"):
        if k in acc["metrics"] and k in metrics5:
            log(f"  {k}: {acc['metrics'][k]} with the catalogue, {metrics5[k]} in phase 5")
    fp, fp_near = false_snvs(records, truth[0], tandem)
    log(f"  false SNV calls: {len(fp)}, of them {fp_near} within 150 bp of a tandem "
        f"array; SNV precision {acc['metrics']['snv_precision']} with the catalogue, "
        f"{metrics5['snv_precision']} in phase 5; positions {fp[:60].tolist()}")
    digest = records_digest(records)
    log(f"  records digest {digest}; the JAX package's on the CPU {PHASE10_RECORDS}")
    if acc["gates"]:
        fail("known-STR accuracy gates: " + "; ".join(acc["gates"]))
    if digest != PHASE10_RECORDS:
        fail(f"phase 10: the records {digest} are not the JAX package's {PHASE10_RECORDS}")
    if al.tier2_reads == 0 or (
        device == "cuda"
        and min(list(t2.values()) + list(t2_walk.values()) + list(launches.values())) == 0
    ):
        fail(f"the known-STR run did not launch every kernel: {launches}, {t2}, {t2_walk}")
    return launches, shapes, t2_walk


def _tier2_args(side, shape):
    """Flank jobs of one launched shape on the card, made from the shape."""
    import torch

    B, Lq, Ls, _ = shape
    rng = np.random.default_rng([B, Lq, Ls, side == "left"])
    return [torch.from_numpy(a).cuda() for a in _tier2_chunk(rng, B, side, Lq, Ls)]


def phase_tier2_shapes(shapes):
    """The Gotoh kernel at EVERY shape that the known-STR run at full width
    launched with a free query end: bit for bit against the plain version
    and timed, so that launches x ms is the run's tier-2 kernel time.  The
    shape that takes most of that time on each side, and the widest one,
    also get the plain version's time and the bound; the first is the
    side's entry in the kernels line.  Then the run-jump walk of
    affine_gap_align_batch on each side's first shape, kernel against the
    plain walk."""
    import torch

    from ngsepcore_tpu_torch.kernels import pairwise
    from ngsepcore_tpu_torch.kernels.pairwise_cuda import (
        gotoh_forward_plane,
        gotoh_forward_plane_ref,
    )

    entries = {}
    for side, cfg in (("left", TIER2_LEFT), ("right", TIER2_RIGHT)):
        per = {}
        for shape, n in sorted(shapes[side].items(), key=lambda kv: kv[0][2]):
            args = _tier2_args(side, shape)
            ref = gotoh_forward_plane_ref(*args, **cfg)
            got = gotoh_forward_plane(*args, **cfg)
            torch.cuda.synchronize()
            full, vec_bad, err = _gotoh_mismatches(got, ref)
            if full or any(vec_bad):
                fail(f"gotoh disagrees with its plain version at the tier-2 {side} "
                     f"shape {shape}: plane {full}, vectors {vec_bad}")
            del got, ref
            ms = cuda_ms(lambda: gotoh_forward_plane(*args, **cfg), calls=20)
            per[shape] = (n, ms, err)
        total = sum(n * ms for n, ms, _ in per.values())
        by_kernel = Counter()
        for shape, (n, _, _) in per.items():
            by_kernel[shape[3]] += n
        log(f"phase 10 tier-2 {side} flank kernel: {sum(by_kernel.values())} launches "
            f"({dict(by_kernel)}) over {len(per)} shapes, each bit-exact; launches x "
            f"ms = {total:.4f} ms in all; " + ", ".join(
                f"{n} x {B}x{Lq}x{Ls} {kern} {ms:.4f} ms"
                for (B, Lq, Ls, kern), (n, ms, _) in per.items()))
        top = max(per, key=lambda sh: per[sh][0] * per[sh][1])
        widest = max(per, key=lambda sh: (sh[2], sh[0]))
        for label, shape in (("most of the time", top), ("widest", widest)):
            if label == "widest" and shape == top:
                continue
            B, Lq, Ls, kern = shape
            args = _tier2_args(side, shape)
            plain = cuda_ms(lambda: gotoh_forward_plane_ref(*args, **cfg))
            b_ms, b_by = gotoh_bound(B, Lq, Ls)
            ms = per[shape][1]
            log(f"  {side} flank, {label}: {B}x{Lq}x{Ls} {kern} kernel {ms:.4f} ms "
                f"(median of 5 x 20 calls), plain {plain:.3f} ms (median of 5); bound "
                f"{b_ms:.4f} ms by {b_by}, kernel at {100 * b_ms / ms:.1f}% of it")
            if label == "most of the time":
                entries[side] = dict(
                    ms=ms, plain_ms=plain, max_abs_err=per[shape][2], bound_ms=b_ms,
                    bound_by=b_by,
                    shape=f"{B}x{Lq}x{Ls}", kernel=kern, total_ms=total)
        # the run-jump walk of affine_gap_align_batch (budget Lq + Ls) on
        # the plane of the shape that takes most of the side's kernel time
        B, Lq, Ls, _ = top
        args = _tier2_args(side, top)
        plane, score, end_i, end_j, start_k = gotoh_forward_plane(*args, **cfg)
        wargs = (plane, score, end_i, end_j, start_k, B, Lq + Ls, cfg["free_start2"])
        got = pairwise._runs_from_plane(*wargs)
        ref = pairwise._runs_from_plane_ref(*wargs)
        if any(not torch.equal(got[k], ref[k]) for k in ref):
            fail(f"the walk kernel disagrees with the plain walk at the tier-2 {side} "
                 f"shape {top}")
        ms = cuda_ms(lambda: pairwise._runs_from_plane(*wargs), calls=20)
        g_ms = graph_ms(lambda: pairwise._runs_from_plane(*wargs))
        plain = cuda_ms(lambda: pairwise._runs_from_plane_ref(*wargs))
        b_ms, b_by = walk_bound(B, Lq + Ls, walk_loads(plane, end_i, end_j, start_k,
                                                       Lq + Ls))
        log(f"  {side} flank walk at {B}x{Lq}x{Ls}, R {Lq + Ls}: kernel {ms:.4f} ms "
            f"(median of 5 x 20 calls), {g_ms:.4f} ms in a CUDA graph of 20 calls, "
            f"plain {plain:.3f} ms (median of 5); bound {b_ms:.4f} ms by {b_by}, kernel "
            f"at {100 * b_ms / ms:.1f}% of it ({100 * b_ms / g_ms:.1f}% in the graph)")
        entries[side]["walk"] = dict(ms=ms, plain_ms=plain, max_abs_err=0, bound_ms=b_ms,
                                     bound_by=b_by, graph_ms=g_ms,
                                     shape=f"{B}x{Lq}x{Ls} R {Lq + Ls}", mode="runs")
        del plane, got, ref
    return entries


def _valid_windows(codes, lengths, k):
    """Number of length-k windows inside the reads that hold ACGT only."""
    acgt = (codes < 4) & (np.arange(codes.shape[1])[None, :] < lengths[:, None])
    csum = np.cumsum(acgt, axis=1, dtype=np.int32)
    full = csum[:, k - 1 :] - np.concatenate(
        [np.zeros((len(codes), 1), np.int32), csum[:, : -k]], axis=1)
    return int((full == k).sum())


def _cli_plain(args, device, timeout=900, threads=None):
    """Run a command of the port's CLI to its end: (seconds, stdout,
    stderr); fails the run on a nonzero exit.  `threads` caps torch's CPU
    threads."""
    cmd = [sys.executable, "-m", "ngsepcore_tpu_torch", "--device", device] + args
    env = dict(os.environ, PYTHONPATH=ROOT)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    if out.returncode != 0:
        print(out.stderr[-4000:], flush=True)
        fail(f"CLI {args[0]} on {device} exited {out.returncode}")
    return time.perf_counter() - t0, out.stdout, out.stderr


def _cli_both(args_for, device, timeout):
    """Run one command on `device` and on the CPU side by side (the CPU run
    only serves the comparison); returns {device: seconds}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        runs = {dev: pool.submit(_cli_plain, args_for(dev), dev, timeout)
                for dev in dict.fromkeys((device, "cpu"))}
        return {dev: run.result()[0] for dev, run in runs.items()}


def _read_distribution(path):
    with open(path) as fh:
        rows = [line.split() for line in fh.read().splitlines()[1:]]
    return np.array([int(r[1]) for r in rows], np.int64)


def phase_kmers(d, genome, reads, device="cuda"):
    """KmersExtractor (k = 15, both strands) on phase 5's FASTQ and FASTA
    (phase 8's files, written here when phase 8 did not run) and
    ReadsFileErrorsCorrector on the first 20,000 reads, through the CLI on
    the card; counting invariants, CUDA against the CPU, and the card's
    outputs held to the JAX package's CPU digests PHASE11_READS_KMERS,
    PHASE11_GENOME_KMERS and PHASE11_CORRECTED."""
    from ngsepcore_tpu_torch.io.fastq import write_fastq

    k = 15
    g, fq = os.path.join(d, "genome.fa"), os.path.join(d, "reads.fastq")
    if not (os.path.exists(g) and os.path.exists(fq)):
        t0 = time.perf_counter()
        _write_inputs(d, genome, reads)
        log(f"phase 11 inputs: {len(reads)} reads -> FASTQ ({time.perf_counter() - t0:.1f}s)")
    # reads: every valid window counted once on each strand
    t = _cli_plain(["KmersExtractor", "-k", str(k), "-o", os.path.join(d, "kr"), fq],
                   device, 600)[0]
    with np.load(os.path.join(d, "kr_kmers.npz")) as z:
        codes, counts = z["codes"], z["counts"]
    want = 2 * _valid_windows(reads.codes, reads.lengths, k)
    dist = _read_distribution(os.path.join(d, "kr_kmers_distribution.txt"))
    log(f"phase 11 KmersExtractor k={k} on {len(reads)} reads: {t:.2f}s (process "
        f"wall); {int(counts.sum(dtype=np.int64))} k-mers counted, {want} expected; "
        f"{len(codes)} distinct, distribution sums to {int(dist.sum())}; "
        f"largest count {int(counts.max())}")
    if int(counts.sum(dtype=np.int64)) != want:
        fail("k-mer total of the reads differs from 2 * valid windows")
    if int(dist.sum()) != len(codes) or np.any(np.diff(codes) <= 0):
        fail("k-mer distribution or map of the reads is inconsistent")
    # genome: the same invariants, and CUDA against the CPU
    times = _cli_both(
        lambda dev: ["KmersExtractor", "-k", str(k), "-o", os.path.join(d, f"kg_{dev}"), g],
        device, 600)
    with np.load(os.path.join(d, f"kg_{device}_kmers.npz")) as a, \
            np.load(os.path.join(d, "kg_cpu_kmers.npz")) as b:
        same = all(np.array_equal(a[key], b[key]) for key in ("k", "codes", "counts"))
        gcodes, gcounts = a["codes"], a["counts"]
    want_g = sum(
        2 * _valid_windows(sq.codes[None, :], np.array([len(sq.codes)]), k)
        for sq in genome.sequences)
    dist_c = _read_distribution(os.path.join(d, f"kg_{device}_kmers_distribution.txt"))
    dist_p = _read_distribution(os.path.join(d, "kg_cpu_kmers_distribution.txt"))
    log(f"  genome {genome.total_length} bp: {device} {times[device]:.2f}s, CPU "
        f"{times['cpu']:.2f}s (process wall, side by side); "
        f"{int(gcounts.sum(dtype=np.int64))} k-mers counted, {want_g} expected; "
        f"{len(gcodes)} distinct; map equal {same}, distribution equal {bool(np.array_equal(dist_c, dist_p))}")
    if int(gcounts.sum(dtype=np.int64)) != want_g or int(dist_c.sum()) != len(gcodes):
        fail("k-mer total or distribution of the genome is inconsistent")
    if not same or not np.array_equal(dist_c, dist_p):
        fail("KmersExtractor CUDA and CPU outputs differ on the genome")
    # error correction of the first 20,000 reads
    sub = os.path.join(d, "first.fastq")
    write_fastq(reads[:20000], sub)
    times = _cli_both(
        lambda dev: ["ReadsFileErrorsCorrector", sub, os.path.join(d, f"corr_{dev}.fastq")],
        device, 900)
    with open(os.path.join(d, f"corr_{device}.fastq")) as a, \
            open(os.path.join(d, "corr_cpu.fastq")) as b, open(sub) as c:
        out_cuda, out_cpu, src = a.read(), b.read(), c.read()
    n_changed = sum(x != y for x, y in zip(out_cuda.splitlines()[1::4],
                                           src.splitlines()[1::4]))
    log(f"  ReadsFileErrorsCorrector on 20000 reads: {device} {times[device]:.2f}s, CPU "
        f"{times['cpu']:.2f}s (process wall, side by side); {n_changed} reads changed; "
        f"outputs equal {out_cuda == out_cpu}")
    if out_cuda != out_cpu or out_cuda.count("\n") != src.count("\n"):
        fail("ReadsFileErrorsCorrector CUDA and CPU outputs differ")
    digests = {
        "reads_kmers": kmers_digest(os.path.join(d, "kr")),
        "genome_kmers": kmers_digest(os.path.join(d, f"kg_{device}")),
        "corrected": lines_digest(file_lines(os.path.join(d, f"corr_{device}.fastq"))),
    }
    want = {"reads_kmers": PHASE11_READS_KMERS, "genome_kmers": PHASE11_GENOME_KMERS,
            "corrected": PHASE11_CORRECTED}
    log(f"  phase 11 digests: {json.dumps(digests)}")
    for name, digest in digests.items():
        if tuple(digest) != want[name]:
            fail(f"phase 11: the {name} digest {digest} is not the JAX package's {want[name]}")


# ---------------------------------------------------------------------------
# -minQuality of the 6x population run.  At 6x a heterozygous site seldom
# reaches the default 40 (about half of the true sites would be called), so
# a low-coverage population is called at 10; the share of the records that
# the default keeps is printed beside it.
POP_MIN_QUALITY = 10


def _vcf_body(records, samples, writer=None):
    """The records as the lines `writer` (a package's VCFFileWriter class;
    the port's by default) prints for them."""
    import io

    if writer is None:
        from ngsepcore_tpu_torch.vcf.io import VCFFileWriter as writer

    buf = io.StringIO()
    w = writer(buf, samples)
    for r in records:
        w.write(r)
    return [l for l in buf.getvalue().splitlines() if not l.startswith("#")]


def _genome_of(name, codes, classes=None):
    """A one-sequence ReferenceGenome of `classes` (port_classes() by
    default; see real_size_inputs)."""
    k = classes or port_classes()
    seqs = k.QualifiedSequenceList()
    seqs.add(k.QualifiedSequence(name=name, codes=codes))
    return k.ReferenceGenome(seqs)


def _with_svs(hap_genome, dup, dele, classes=None):
    """The haplotype genome with a tandem duplication of [dup) and without
    [dele) (0-based half-open, dup left of dele; both homozygous when every
    haplotype gets them)."""
    c = hap_genome.sequences[0].codes
    assert dup[1] <= dele[0]
    c = np.concatenate([c[: dup[1]], c[dup[0] : dele[0]], c[dele[1] :]])
    return _genome_of(hap_genome.sequence_name(0), c, classes)


def _align_all(aligner, reads, batch):
    alns = []
    for i in range(0, len(reads), batch):
        for per_read in aligner.align_batch(reads[i : i + batch]):
            alns.extend(per_read)
    return alns


def _sample_reads(genome, seed, n_reads, read_len, error, svs=None, classes=None):
    """A diploid individual of `genome` (SNV 0.001, indel 0.0001) and its
    reads, half from each haplotype, built with `classes` (port_classes()
    by default): (truth calls, ReadBlock)."""
    k = classes or port_classes()
    sim = k.SingleIndividualSimulator(genome, snv_rate=0.001, indel_rate=0.0001, seed=seed)
    sim.simulate()
    haps = sim.build_haplotype_genomes()
    if svs:
        haps = [_with_svs(hg, *svs, classes=k) for hg in haps]
    reads = k.ReadBlock.concatenate([
        k.SingleReadsSimulator(
            hg, read_length=read_len, substitution_error_rate=error,
            seed=seed + 1000 * (h + 1),
        ).simulate_block(n_reads // 2)
        for h, hg in enumerate(haps)
    ])
    return sim.calls, reads


def _covering(calls, lo, hi, want):
    """Largest share of [lo, hi) (0-based) that one call with want(copy
    number) covers."""
    best = 0.0
    for c in calls:
        if want(c.copy_number):
            ov = min(c.last, hi) - max(c.first - 1, lo)
            best = max(best, ov / (hi - lo))
    return best


def _call_fields(calls):
    import dataclasses

    return [dataclasses.asdict(c) for c in calls]


def _cli_pairs(jobs, device, timeout=600):
    """Run every CLI command of `jobs` ({label: (args, outputs)}) on `device`
    and on the CPU, all processes side by side (`{dev}` in an argument is
    "dev" for the first and "ref" for the second); fail unless all exit 0
    and every output file is byte-equal.  Returns {label: output sizes}."""
    procs = {}
    try:
        for label, (args, _) in jobs.items():
            for dev, name in ((device, "dev"), ("cpu", "ref")):
                cmd = [sys.executable, "-m", "ngsepcore_tpu_torch", "--device", dev] + [
                    a.format(dev=name) for a in args]
                procs[label, dev] = subprocess.Popen(
                    cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for (label, dev), proc in procs.items():
            _, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                print(err[-4000:], flush=True)
                fail(f"CLI {label} on {dev} exited {proc.returncode}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    sizes = {}
    for label, (_, outputs) in jobs.items():
        sizes[label] = []
        for out in outputs:
            with open(out.format(dev="dev"), "rb") as fa, open(out.format(dev="ref"), "rb") as fb:
                da, db = fa.read(), fb.read()
            if da != db or not da:
                fail(f"CLI {label}: {out} differs between {device} and cpu (or is empty)")
            sizes[label].append(len(da))
    return sizes


def phase_population_small(counters, device="cuda"):
    """Phase 12, CUDA against CPU on a 50 kb genome: joint calling of 3
    samples, the four CNV algorithms, the read-pair SV stage of the
    detector, and the four new CLI commands."""
    import copy

    from ngsepcore_tpu_torch.align.paired import PairedReadsAligner
    from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner
    from ngsepcore_tpu_torch.call.multisample import MultisampleVariantsDetector
    from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector
    from ngsepcore_tpu_torch.core.sequences import RawRead, decode_dna
    from ngsepcore_tpu_torch.io.fasta import save_fasta
    from ngsepcore_tpu_torch.io.sam import ReadAlignmentFileWriter

    L = 50_000
    rng = np.random.default_rng(12)
    genome = _genome_of("chrP", rng.integers(0, 4, size=L).astype(np.int8))
    aligner = ReadsAligner(genome, device=device)
    samples = ["s0", "s1", "s2"]
    dup, dele = (12_000, 18_000), (30_000, 34_000)
    t0 = time.perf_counter()
    alns = []
    for i in range(3):
        _, reads = _sample_reads(genome, 300 + i, 6000, 100, 0.003,
                                 svs=(dup, dele) if i == 2 else None)
        alns.append(_align_all(aligner, reads, 4096))
    t_align = time.perf_counter() - t0

    # joint calling: the realigner edits alignments, so each run gets copies
    reset_counts(counters)
    out = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        recs = MultisampleVariantsDetector(genome, device=dev).find_variants(
            copy.deepcopy(alns), samples)
        sync(dev)
        out[dev] = (_vcf_body(recs, samples), time.perf_counter() - t0)
    n_diff = sum(a != b for a, b in zip(out[device][0], out["cpu"][0]))
    log(f"phase 12 population 50 kb, 3 samples x {len(alns[0])} alignments (aligned on "
        f"{device} in {t_align:.2f}s): {len(out[device][0])} records on {device} "
        f"({out[device][1]:.2f}s), {len(out['cpu'][0])} on CPU ({out['cpu'][1]:.2f}s), "
        f"lines differing {n_diff}")
    if len(out[device][0]) < 50 or out[device][0] != out["cpu"][0]:
        for a, b in zip(out[device][0], out["cpu"][0]):
            if a != b:
                print(f"  {device}:", a, "\n  cpu: ", b, flush=True)
        fail("population records differ between {device} and CPU")
    if not all(l.count("\t") == 8 + 3 for l in out[device][0]):
        fail("a population record lacks a sample column")

    # read-depth CNVs of the sample that carries the duplication and deletion
    calls = {}
    for dev in (device, "cpu"):
        det = SingleSampleVariantsDetector(
            genome, sample_id="s2", alg_cnv=ALL_CNV_ALGORITHMS, device=dev)
        calls[dev] = det.find_cnv_calls(alns[2])
    n_launch = counters[-1].launches
    log(f"  CNV calls of s2, {ALL_CNV_ALGORITHMS}: {len(calls[device])} on {device}, "
        f"{len(calls['cpu'])} on CPU; duplication covered "
        f"{_covering(calls[device], *dup, lambda cn: cn >= 3):.2f}, deletion "
        f"{_covering(calls[device], *dele, lambda cn: cn <= 1):.2f}; viterbi "
        f"launches {n_launch}")
    if not calls[device] or _call_fields(calls[device]) != _call_fields(calls["cpu"]):
        fail("CNV calls differ between {device} and CPU")
    if device == "cuda" and n_launch != 2:
        fail(f"the two HMM algorithms launched the Viterbi kernel {n_launch} times")

    with tempfile.TemporaryDirectory() as d:
        # paired reads over a 2 kb deletion through PairedReadsAligner
        pdel = (24_000, 26_000)
        ref = genome.sequences[0].codes
        ind = np.concatenate([ref[: pdel[0]], ref[pdel[1] :]])
        r1, r2 = [], []
        for i in range(4000):
            s0 = int(rng.integers(0, len(ind) - 400))
            frag = ind[s0 : s0 + 400]
            r1.append(RawRead(f"p{i}/1", decode_dna(frag[:100]), "I" * 100))
            r2.append(RawRead(f"p{i}/2", decode_dna((3 - frag[-100:][::-1]).astype(np.int8)),
                              "I" * 100))
        pa = PairedReadsAligner(aligner)
        sam = os.path.join(d, "pairs.sam")
        with ReadAlignmentFileWriter(genome.sequences, sam, sample_id="pairs") as w:
            for i in range(0, len(r1), 1024):
                for per_pair in pa.align_batch(r1[i : i + 1024], r2[i : i + 1024]):
                    for a in per_pair:
                        w.write(a)
        body = lambda path: [l for l in open(path) if not l.startswith("#")]
        for dev in (device, "cpu"):
            SingleSampleVariantsDetector(
                genome, sample_id="pairs", find_svs=True, device=dev,
            ).run(sam, os.path.join(d, f"sv_{dev}.vcf"))
        vcf = body(os.path.join(d, f"sv_{device}.vcf"))
        gff = body(os.path.join(d, f"sv_{device}_SV.gff"))
        dels = [l.split("\t") for l in vcf if "SVTYPE=DEL" in l]
        log(f"  read-pair SVs, {pa.proper_pairs}/{pa.pairs} proper pairs: {len(vcf)} VCF "
            f"lines, {len(gff)} GFF lines, deletions at {[int(f[1]) for f in dels]}")
        if vcf != body(os.path.join(d, "sv_cpu.vcf")) or gff != body(
                os.path.join(d, "sv_cpu_SV.gff")):
            fail("-svs outputs differ between {device} and CPU")
        if not gff or not any(abs(int(f[1]) - pdel[0]) < 500 for f in dels):
            fail("the planted deletion was not called from the read pairs")

        # the four new CLI commands, cuda beside cpu
        g = os.path.join(d, "g.fa")
        save_fasta(genome.sequences, g)
        sams = []
        for name, sample_alns in zip(samples, alns):
            sams.append(os.path.join(d, name + ".sam"))
            with ReadAlignmentFileWriter(genome.sequences, sams[-1], sample_id=name) as w:
                for a in sample_alns:
                    w.write(a)
        t0 = time.perf_counter()
        out_of = lambda name: os.path.join(d, name)
        sizes = _cli_pairs({
            "MultisampleVariantsDetector": (
                ["MultisampleVariantsDetector", "-r", g, "-o", out_of("pop_{dev}.vcf"), *sams],
                [out_of("pop_{dev}.vcf")]),
            "ReadDepthComparator": (
                ["ReadDepthComparator", "-r", g, "-o", out_of("rd_{dev}.txt"),
                 sams[2], sams[0]],
                [out_of("rd_{dev}.txt")]),
            "CoverageStats": (
                ["CoverageStats", "-r", g, "-i", sams[1], "-o", out_of("cov_{dev}.txt")],
                [out_of("cov_{dev}.txt")]),
            "BasePairQualStats": (
                ["BasePairQualStats", "-r", g, "-i", sams[1], "-o", out_of("bq_{dev}.txt")],
                [out_of("bq_{dev}.txt")]),
            "SingleSampleVariantsDetector -cnvs -svs": (
                ["SingleSampleVariantsDetector", "-r", g, "-i", sams[2], "-o",
                 out_of("cnv_{dev}"), "-sampleId", "s2", "-cnvs", "-svs", "-algCNV",
                 ALL_CNV_ALGORITHMS],
                [out_of("cnv_{dev}.vcf"), out_of("cnv_{dev}_SV.gff")]),
        }, device)
        cli_pop = body(os.path.join(d, "pop_dev.vcf"))
        log(f"  CLI {device} against cpu, outputs byte-equal (bytes): {sizes} "
            f"({time.perf_counter() - t0:.1f}s)")
        if [l.rstrip("\n") for l in cli_pop] != out[device][0]:
            fail("the CLI's population VCF differs from find_variants' records")


POP_BATCH = 32_768  # phase 13's alignment batch
POP_CNV_RUNS = (ALL_CNV_ALGORITHMS, "PoissonHMM", "MAXIMUMLIKELIHOOD")


def population_inputs(genome, in_repeat, classes=None, n_reads=184_000, dup_len=20_000,
                      del_len=10_000) -> dict:
    """Phase 13's samples on phase 5's genome and its in_repeat mask
    (real_size_inputs): 3 diploid individuals at 6x each (seeds 101-103,
    _sample_reads), the third with a homozygous tandem duplication of
    `dup_len` and a homozygous deletion of `del_len`, each at the first
    window after 1/5 and 3/5 of the genome that touches no repeat.  Built
    with `classes` (port_classes() by default).  Returns samples, truths
    ({first: call} of each sample's SNVs), dup, dele (0-based half-open)
    and blocks (each sample's ReadBlock)."""
    L = genome.sequence_length(0)

    def unique_window(start, length):
        """First window of `length` at or after `start` that touches no
        repeat (with its read-length margin)."""
        step = 1000
        for lo in range(start, L - length, step):
            if not in_repeat[lo : lo + length].any():
                return lo, lo + length
        fail(f"no unique window of {length} bp after {start}")

    dup = unique_window(L // 5, dup_len)
    dele = unique_window((3 * L) // 5, del_len)
    truths, blocks = [], []
    for i in range(3):
        calls, reads = _sample_reads(genome, 101 + i, n_reads, READ_LEN, 0.003,
                                     svs=(dup, dele) if i == 2 else None, classes=classes)
        truths.append({c.first: c for c in calls if c.is_snv})
        blocks.append(reads)
    return dict(samples=["ind0", "ind1", "ind2"], truths=truths, dup=dup, dele=dele,
                blocks=blocks)


def population_accuracy(records, truths, in_repeat) -> dict:
    """Phase 13's accuracy figures and gates from the joint records (either
    package's) and population_inputs' truths: SNV precision, recall in
    unique regions and per-sample genotype concordance over decided calls
    at truth sites, the same at the default -minQuality 40 (a record's
    quality is the best GQ of its non-reference calls), and `passed`."""
    all_truth = set().union(*truths)
    called = {r.variant.first for r in records if r.variant.is_snv}
    unique_truth = {p for p in all_truth if not in_repeat[p]}
    checked = [0, 0, 0]
    concordant = [0, 0, 0]
    for r in records:
        p = r.variant.first
        if not r.variant.is_snv or p not in all_truth:
            continue
        for si, call in enumerate(r.calls):
            if call.is_undecided:
                continue
            t = truths[si].get(p)
            checked[si] += 1
            concordant[si] += call.genotype_state == (0 if t is None else t.genotype_state)
    called40 = {r.variant.first for r in records
                if r.variant.is_snv and r.variant.quality >= 40}
    out = dict(
        called=len(called), truth=len(all_truth), unique_truth=len(unique_truth),
        precision=len(called & all_truth) / max(1, len(called)),
        recall_unique=len(called & unique_truth) / max(1, len(unique_truth)),
        concordance=[c / max(1, n) for c, n in zip(concordant, checked)], checked=checked,
        called40=len(called40),
        precision40=len(called40 & all_truth) / max(1, len(called40)),
        recall_unique40=len(called40 & unique_truth) / max(1, len(unique_truth)),
    )
    out["passed"] = (out["precision"] >= 0.90 and out["recall_unique"] >= 0.85
                     and min(out["concordance"]) >= 0.95)
    return out


def phase_population_real_size(counters, genome, table, in_repeat, device="cuda"):
    """Phase 13: population_inputs' 3 diploid individuals of phase 5's
    genome at 6x each, aligned in 32,768-read batches, called jointly;
    then the four CNV algorithms on the individual that carries a
    homozygous tandem duplication and a homozygous deletion in unique
    sequence.  The SAM lines, the VCF body and the CNV calls are held to
    the JAX package's CPU digests (PHASE13_*)."""
    import torch

    from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner
    from ngsepcore_tpu_torch.call.multisample import MultisampleVariantsDetector
    from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector
    from ngsepcore_tpu_torch.utils import profiling

    L = genome.sequence_length(0)
    batch = POP_BATCH
    t0 = time.perf_counter()
    pop = population_inputs(genome, in_repeat)
    samples, truths, blocks, dup, dele = (
        pop["samples"], pop["truths"], pop["blocks"], pop["dup"], pop["dele"])
    t_sim = time.perf_counter() - t0
    t0 = time.perf_counter()
    aligner = ReadsAligner(genome, table=table, device=device)
    alns = [_align_all(aligner, reads, batch) for reads in blocks]
    sync(device)
    t_align = time.perf_counter() - t0
    # before find_variants: its realigner edits the alignments
    digests = {"sam": [sam_digest("\t".join(a.to_sam_fields()) for a in sample_alns)
                       for sample_alns in alns]}
    n_total = sum(len(b) for b in blocks)
    log(f"phase 13 inputs: {L} bp, 3 individuals x {len(blocks[0])} reads of {READ_LEN} bp "
        f"({len(blocks[0]) * READ_LEN / L:.2f}x each, {n_total} in all), SNVs "
        f"{[len(t) for t in truths]}; ind2 with a duplication at {dup} and a deletion at "
        f"{dele} (0-based); simulated in {t_sim:.1f}s, aligned in {batch}-read batches on "
        f"{device} in {t_align:.2f}s = {n_total / t_align:.1f} reads/s, "
        f"{[len(a) for a in alns]} alignments")

    profiling.enable()
    profiling.reset()
    reset_counts(counters)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    records = MultisampleVariantsDetector(
        genome, min_quality=POP_MIN_QUALITY, device=device,
    ).find_variants(alns, samples)
    sync(device)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    stages = sorted(profiling._stages.items(), key=lambda kv: -kv[1][0])
    profiling.reset()
    digests["vcf"] = vcf_body_digest(_vcf_body(records, samples))
    log(f"  MultisampleVariantsDetector(min_quality={POP_MIN_QUALITY}).find_variants "
        f"(first run): {dt:.3f}s = "
        f"{n_total / dt:.1f} reads/s; {len(records)} records "
        f"({sum(r.variant.is_snv for r in records)} SNV, the rest indel and STR); peak "
        f"device memory {peak / 2**30:.2f} GiB")
    for name, (total, calls) in stages:
        print(f"  stage {name:<28} {total:9.3f}s x{calls}", flush=True)

    t0 = time.perf_counter()
    det = SingleSampleVariantsDetector(
        genome, sample_id="ind2", alg_cnv=ALL_CNV_ALGORITHMS, device=device)
    cnvs = det.find_cnv_calls(alns[2])
    sync(device)
    dt_cnv = time.perf_counter() - t0
    profiling.enable(False)
    launches = {c.__name__: c.launches for c in counters}
    log(f"  find_cnv_calls of ind2, {ALL_CNV_ALGORITHMS}: {dt_cnv:.3f}s, {len(cnvs)} calls; "
        f"launches {launches}")
    for name, (total, calls) in sorted(profiling._stages.items(), key=lambda kv: -kv[1][0]):
        print(f"  stage {name:<28} {total:9.3f}s x{calls}", flush=True)

    # gates
    if not records or not all(len(r.calls) == 3 for r in records):
        fail("a population record does not carry 3 calls")
    acc = population_accuracy(records, truths, in_repeat)
    log(f"  accuracy: SNV records {acc['called']}, truth sites {acc['truth']} "
        f"({acc['unique_truth']} unique), precision {acc['precision']:.4f}, recall in unique "
        f"regions {acc['recall_unique']:.4f}, genotype concordance per sample "
        f"{[round(c, 4) for c in acc['concordance']]} over {acc['checked']} decided calls; "
        f"at quality >= 40: {acc['called40']} SNV records, precision "
        f"{acc['precision40']:.4f}, recall in unique regions {acc['recall_unique40']:.4f}")
    if not acc["passed"]:
        fail("population accuracy gates missed")
    digests["cnv"] = {ALL_CNV_ALGORITHMS: cnv_digest(cnvs)}
    # a call does not name its algorithm: each HMM algorithm runs again alone
    for alg in POP_CNV_RUNS[1:]:
        det.alg_cnv = alg
        before = counters[-1].launches  # viterbi_log's
        own = det.find_cnv_calls(alns[2])
        digests["cnv"][alg] = cnv_digest(own)
        n_launch = counters[-1].launches - before
        cov_dup = _covering(own, *dup, lambda cn: cn >= 3)
        cov_del = _covering(own, *dele, lambda cn: cn <= 1)
        log(f"  {alg}: {len(own)} calls; duplication covered {cov_dup:.3f} by a call of "
            f"copy number >= 3, deletion {cov_del:.3f} by one of copy number <= 1; "
            f"Viterbi launches {n_launch}")
        if cov_dup < 0.80 or cov_del < 0.80:
            fail(f"{alg} missed the planted duplication or deletion")
        if device == "cuda" and n_launch != 1:
            fail(f"{alg}.call_cnvs made {n_launch} Viterbi launches, not one")
    if device == "cuda" and launches["viterbi_log"] == 0:
        fail(f"the CNV stage did not launch the Viterbi kernel: {launches}")
    expect = {"sam": list(PHASE13_SAM), "vcf": PHASE13_VCF, "cnv": PHASE13_CNVS}
    log(f"  phase 13 digests: {json.dumps(digests)}")
    for key, want in expect.items():
        if json.dumps(digests[key], sort_keys=True) != json.dumps(want, sort_keys=True):
            fail(f"phase 13's {key} digest {digests[key]} is not the JAX package's {want}")
    return launches


# ---------------------------------------------------------------------------
LR_INS_AT, LR_INS_LEN = 15_000, 80  # 0-based insertion point in the reads' genome
LR_DEL_AT, LR_DEL_LEN = 40_000, 100  # 0-based first deleted base
LR_BATCH = 128  # bench_configs.bench_long_reads' batch


def _simulate_long_reads_60kb(seed: int = 4):
    """tests/test_long_reads.py's two planted events in a 60 kb genome: the
    reads' genome carries an 80 bp insertion and a 100 bp deletion; 40
    reads of 8 kb and 30 of 4 kb with 1% substitutions and 1% indels."""
    from ngsepcore_tpu_torch.core.sequences import RawRead
    from ngsepcore_tpu_torch.simulation.reads_simulator import SingleReadsSimulator

    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 60_000).astype(np.int8)
    mut = np.concatenate([
        ref[:LR_INS_AT], rng.integers(0, 4, LR_INS_LEN).astype(np.int8),
        ref[LR_INS_AT:LR_DEL_AT], ref[LR_DEL_AT + LR_DEL_LEN :]])
    mg = _genome_of("chr1", mut)
    reads = []
    for n, length, sd in ((40, 8000, 11), (30, 4000, 12)):
        for r in SingleReadsSimulator(mg, read_length=length, substitution_error_rate=0.01,
                                      indel_error_rate=0.01, seed=sd).simulate(n):
            reads.append(RawRead(name=f"{r.name}_{length}", sequence=r.sequence,
                                 qualities=r.qualities))
    return _genome_of("chr1", ref), reads


def _align_long(aligner, reads):
    return [a for i in range(0, len(reads), LR_BATCH)
            for group in aligner.align_batch(reads[i : i + LR_BATCH]) for a in group]


def _long_reads_in_process(genome, reads, device, d):
    """LongReadsAligner in batches of 128, the SAM written, then
    SingleSampleVariantsDetector -runLongReadSVs on it: (SAM lines,
    _SVsLongReads.vcf body, main VCF body)."""
    from ngsepcore_tpu_torch.align.long_reads import LongReadsAligner
    from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector
    from ngsepcore_tpu_torch.io.sam import ReadAlignmentFileWriter

    alns = _align_long(LongReadsAligner(genome, device=device), reads)
    sam = os.path.join(d, f"lr_{device}.sam")
    with ReadAlignmentFileWriter(genome.sequences, sam, sample_id="s1") as w:
        for a in alns:
            w.write(a)
    SingleSampleVariantsDetector(genome, sample_id="s1", device=device,
                                 run_long_read_svs=True).run(sam, os.path.join(
                                     d, f"lr_{device}.vcf"))
    body = lambda p, mark="#": [l for l in open(p) if not l.startswith(mark)]
    return (["\t".join(a.to_sam_fields()) for a in alns],
            body(os.path.join(d, f"lr_{device}_SVsLongReads.vcf")),
            body(os.path.join(d, f"lr_{device}.vcf")))


def _planted_found(sv_lines):
    """(deletion found, insertion found) among _SVsLongReads.vcf lines, as
    tests/test_long_reads.py::test_long_read_sv_detection asks."""
    recs = [(int(f[1]), f[7]) for f in (l.split("\t") for l in sv_lines)]
    info = lambda s, key: next((int(x.split("=")[1]) for x in s.split(";")
                                if x.startswith(key + "=")), 0)
    dele = any("SVTYPE=DEL" in s and abs(p - (LR_DEL_AT + 1)) < 150
               and 60 <= abs(info(s, "SVLEN")) <= 140 for p, s in recs)
    ins = any("SVTYPE=INS" in s and abs(p - LR_INS_AT) < 150
              and 50 <= abs(info(s, "SVLEN")) <= 110 for p, s in recs)
    return dele, ins


def phase_long_reads_small(counters, device="cuda"):
    """The long-read path at 60 kb on `device` against the CPU, in process
    and through the CLI (ReadsAligner -p PACBIO, then
    SingleSampleVariantsDetector -runLongReadSVs): SAM lines and
    _SVsLongReads.vcf bodies equal, both planted events found."""
    from ngsepcore_tpu_torch.io.fasta import save_fasta
    from ngsepcore_tpu_torch.io.fastq import write_fastq

    genome, reads = _simulate_long_reads_60kb()
    with tempfile.TemporaryDirectory() as d:
        reset_counts(counters)
        t0 = time.perf_counter()
        with plain_post_pass_forbidden(device):
            sam_d, sv_d, vcf_d = _long_reads_in_process(genome, reads, device, d)
        sync(device)
        t_dev = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        if device == "cuda":
            walk_route(counters, "hamming", "phase 14, long reads")
        t0 = time.perf_counter()
        sam_c, sv_c, vcf_c = _long_reads_in_process(genome, reads, "cpu", d)
        t_cpu = time.perf_counter() - t0
        dele, ins = _planted_found(sv_d)
        log(f"phase 14 long reads 60 kb, {len(reads)} reads of 4-8 kb: {len(sam_d)} SAM "
            f"lines, {len(sv_d)} long-read SV records, {len(vcf_d)} VCF records on "
            f"{device} ({t_dev:.2f}s), CPU ({t_cpu:.2f}s); SAM lines differing "
            f"{sum(a != b for a, b in zip(sam_d, sam_c))}; planted deletion found {dele}, "
            f"insertion found {ins}; launches {launches}")
        if sam_d != sam_c or sv_d != sv_c or vcf_d != vcf_c:
            fail(f"long-read SAM or VCF bodies differ between {device} and the CPU")
        if not (dele and ins):
            fail("a planted long-read SV was not called")
        if device == "cuda" and min(launches.values()) == 0:
            fail(f"the long-read path did not launch every kernel: {launches}")
        g, fq = os.path.join(d, "lr.fa"), os.path.join(d, "lr.fastq")
        save_fasta(genome.sequences, g)
        write_fastq(reads, fq)
        out = lambda dev, ext: os.path.join(d, f"cli_{dev}{ext}")
        times = _cli_both(lambda dev: ["ReadsAligner", "-r", g, "-o", out(dev, ".sam"),
                                       "-s", "s1", "-p", "PACBIO", fq], device, 600)
        times_v = _cli_both(lambda dev: [
            "SingleSampleVariantsDetector", "-r", g, "-i", out(dev, ".sam"), "-o",
            out(dev, ""), "-sampleId", "s1", "-runLongReadSVs"], device, 600)
        body = lambda p, mark="#": [l for l in open(p) if not l.startswith(mark)]
        sam_cli = {dev: body(out(dev, ".sam"), "@") for dev in times}
        sv_cli = {dev: body(out(dev, "_SVsLongReads.vcf")) for dev in times}
        log(f"  CLI ReadsAligner -p PACBIO: {device} {times[device]:.2f}s, CPU "
            f"{times['cpu']:.2f}s; SingleSampleVariantsDetector -runLongReadSVs: "
            f"{device} {times_v[device]:.2f}s, CPU {times_v['cpu']:.2f}s (process wall, "
            f"side by side); {len(sam_cli[device])} SAM lines, {len(sv_cli[device])} "
            "long-read SV records")
        if sam_cli[device] != sam_cli["cpu"] or sv_cli[device] != sv_cli["cpu"]:
            fail(f"long-read CLI outputs differ between {device} and the CPU")
        if [l.rstrip("\n") for l in sam_cli[device]] != sam_d or sv_cli[device] != sv_d:
            fail("the long-read CLI's outputs differ from the in-process run's")
    return launches


def _long_read_gotoh_shapes(gotoh):
    """Gotoh launches of the long-read segment kinds since the last
    reset_counts: {(kind, B, Lq, Ls, kernel): n}."""
    kinds = {(False, False, c["free_start2"], c["free_end2"]): kind
             for kind, c in LONG_READ_CFGS.items()}
    return Counter({(kinds[ends], *shape): n
                    for (ends, *shape), n in gotoh.launch_shapes.items() if ends in kinds})


def long_read_inputs(classes=None, length=4_000_000, n_reads=600):
    """bench_configs.bench_long_reads' input, built with `classes`
    (port_classes() by default; see real_size_inputs): the first `length`
    bp of bench.py's 12 Mbp repeat genome as chr1 and `n_reads` reads of 10
    kb (1% substitutions, 1% indels, seed 77).  Returns (genome, reads)."""
    k = classes or port_classes()
    genome = _genome_of("chr1", _bench_genome_codes()[:length].copy(), k)
    reads = k.SingleReadsSimulator(genome, read_length=10_000, substitution_error_rate=0.01,
                                   indel_error_rate=0.01, seed=77).simulate(n_reads)
    return genome, reads


def phase_long_reads_real_size(counters, device="cuda"):
    """bench_configs.bench_long_reads' input: 600 reads of 10 kb (1%
    substitutions, 1% indels) against the first 4 Mbp of bench.py's 12 Mbp
    repeat genome, in batches of 128: a warm-up run, two timed runs, the
    stage profile, launches by shape and peak device memory of the second;
    bench_long_reads' accuracy; then the long-read SV caller on its
    alignments.  Every run's SAM lines and the SV calls are held to the
    JAX package's CPU digests (PHASE15_SAM, PHASE15_SVS)."""
    import torch

    from ngsepcore_tpu_torch.align.long_reads import LongReadsAligner
    from ngsepcore_tpu_torch.call.long_read_sv import LongReadStructuralVariantDetector
    from ngsepcore_tpu_torch.index.minimizer_table import MinimizerTable
    from ngsepcore_tpu_torch.simulation.reads_simulator import parse_simulated_read_name
    from ngsepcore_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    genome, reads = long_read_inputs()
    bases = sum(len(r.sequence) for r in reads)
    log(f"phase 15 inputs: {genome.total_length} bp, {len(reads)} reads, {bases} bases "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    table = MinimizerTable.build_from_genome(genome, device=device)
    sync(device)
    log(f"  index on {device}: {len(table.unique_codes)} codes, {table.size} entries, "
        f"{time.perf_counter() - t0:.2f}s")

    sams = []

    def run():
        al = LongReadsAligner(genome, table=table, device=device)
        t0 = time.perf_counter()
        groups = [g for i in range(0, len(reads), LR_BATCH)
                  for g in al.align_batch(reads[i : i + LR_BATCH])]
        sync(device)
        dt = time.perf_counter() - t0
        sams.append(sam_digest("\t".join(a.to_sam_fields()) for g in groups for a in g))
        return al, groups, dt

    _, _, warm = run()
    _, _, dt1 = run()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    profiling.enable()
    profiling.reset()
    reset_counts(counters)
    al, groups, dt = run()
    profiling.enable(False)
    launches = {c.__name__: c.launches for c in counters}
    walk_shapes = Counter(counters[1].launch_shapes)  # counters: (gotoh, walk)
    gotoh_shapes = _long_read_gotoh_shapes(counters[0])
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    correct = checked = 0
    for read, group in zip(reads, groups):
        if group:
            sname, first, _ = parse_simulated_read_name(read.name)
            checked += 1
            correct += group[0].sequence_name == sname and abs(group[0].first - first) <= 50
    aligned = al.aligned_reads / max(al.total_reads, 1)
    placed = correct / max(checked, 1)
    log(f"  warm-up run {warm:.3f}s; timed runs {dt1:.3f}s, {dt:.3f}s = "
        f"{len(reads) / dt:.1f} reads/s, {bases / dt / 1e6:.3f} query Mbp/s (second); "
        f"aligned_frac {aligned:.4f}, placed within 50 bp {correct} of {checked} = "
        f"{placed:.4f}; peak device memory {peak / 2**20:.1f} MiB; launches {launches}")
    for name, (total, calls) in sorted(profiling._stages.items(), key=lambda kv: -kv[1][0]):
        print(f"  stage {name:<28} {total:9.3f}s x{calls}", flush=True)
    log("  gotoh launches by (kind, B, Lq, Ls, kernel): " + ", ".join(
        f"{n} x {k}" for k, n in sorted(gotoh_shapes.items())))
    log("  walk launches by (mode, B, Lq, Ls, R, free_start2): " + ", ".join(
        f"{n} x {k}" for k, n in sorted(walk_shapes.items())))
    t0 = time.perf_counter()
    svs = LongReadStructuralVariantDetector(genome).find_variants(
        [a for g in groups for a in g])
    log(f"  LongReadStructuralVariantDetector.find_variants: {len(svs)} calls, "
        f"{time.perf_counter() - t0:.3f}s (no planted events)")
    log(f"  phase 15 digests: SAM of the three runs {json.dumps(sams)}, SVs "
        f"{json.dumps(sv_digest(svs))}")
    if any(d != PHASE15_SAM for d in sams) or sv_digest(svs) != PHASE15_SVS:
        fail(f"phase 15's SAM or SV digests are not the JAX package's {PHASE15_SAM}, "
             f"{PHASE15_SVS}")
    if aligned < 0.95 or placed < 0.95:
        fail(f"long-read accuracy gates: aligned_frac {aligned}, placed {placed}")
    if device == "cuda" and min(launches.values()) == 0:
        fail(f"the long-read run did not launch every kernel: {launches}")
    if device == "cuda":
        walk_route(counters, "hamming", "phase 15, long reads")
    return launches, gotoh_shapes, walk_shapes


# ---------------------------------------------------------------------------
# de-novo assembly (phases 16, 17)

def _sim_asm_reads(genome_codes, L, cov, rl, seed=31, err=0.01, classes=None):
    """bench_configs._sim_asm_reads with `classes`' reverse complement (the
    port's by default): L * cov // rl reads of rl bp from genome_codes[:L]
    with substitution and indel errors (2:1 at `err` in all), half of them
    reverse-complemented."""
    reverse_complement_codes = (classes or port_classes()).reverse_complement_codes
    rng = np.random.default_rng(seed)
    g = genome_codes[:L]
    reads = []
    for _ in range(L * cov // rl):
        s = int(rng.integers(0, max(1, L - rl)))
        codes = g[s : s + rl].copy()
        idx = np.nonzero(rng.random(rl) < err * 2 / 3)[0]
        if len(idx):
            codes[idx] = (codes[idx] + rng.integers(1, 4, size=len(idx)).astype(np.int8)) % 4
        pieces, prev = [], 0
        for p in np.nonzero(rng.random(rl) < err / 3)[0]:
            pieces.append(codes[prev:p])
            if rng.random() < 0.5:
                prev = p + 1
            else:
                pieces.append(np.array([rng.integers(0, 4)], np.int8))
                prev = p
        pieces.append(codes[prev:])
        codes = np.concatenate(pieces).astype(np.int8)
        if rng.random() < 0.5:
            codes = reverse_complement_codes(codes)
        reads.append(codes)
    return reads


def _asm_identity(contigs, genome_codes, L) -> float:
    """bench_configs._asm_identity: the fraction of truth 32-mers, sampled
    every max(250, L/200) bp, found exactly in the contigs (either strand)."""
    from ngsepcore_tpu_torch.core.sequences import decode_dna, reverse_complement_codes

    gtext = decode_dna(genome_codes[:L])
    texts = []
    for c in contigs:
        texts += [decode_dna(c), decode_dna(reverse_complement_codes(c))]
    blob = "#".join(texts)
    wins = range(0, L - 32, max(250, L // 200))
    return sum(gtext[off : off + 32] in blob for off in wins) / max(1, len(wins))


_REPEAT_GENOME = {}


def _bench_genome_codes():
    """bench.build_repeat_genome(rng 2024, 12 Mbp), built once a process."""
    from bench import build_repeat_genome as bench_genome

    if "codes" not in _REPEAT_GENOME:
        _REPEAT_GENOME["codes"] = bench_genome(np.random.default_rng(2024), 12_000_000)[0]
    return _REPEAT_GENOME["codes"]


def _asm_stats(contigs, genome_codes, L):
    from ngsepcore_tpu_torch.assembly.assembler import n_statistics

    lens = [len(c.codes) for c in contigs]
    n50 = n_statistics(lens).get("N50", 0) if lens else 0
    return dict(n_contigs=len(lens), n50=int(n50), n50_frac=n50 / L,
                identity=_asm_identity([c.codes for c in contigs], genome_codes, L))


def _diploid_reads():
    """tests/test_assembly_polish.py::test_diploid_phased_assembly's input:
    two 20 kb haplotypes one SNV in 300 bp apart, 80 reads of 3 kb each."""
    from ngsepcore_tpu_torch.core.sequences import encode_dna, reverse_complement_codes

    rng = np.random.default_rng(12)
    h0 = encode_dna("".join(rng.choice(list("ACGT"), size=20000)))
    h1 = h0.copy()
    idx = np.arange(150, len(h1) - 150, 300)
    h1[idx] = (h1[idx] + 1) % 4
    reads = []
    for hap in (h0, h1):
        for _ in range(80):
            s = int(rng.integers(0, len(hap) - 3000))
            codes = hap[s : s + 3000].copy()
            e = np.nonzero(rng.random(3000) < 0.003)[0]
            codes[e] = (codes[e] + rng.integers(1, 4, len(e))) % 4
            if rng.random() < 0.5:
                codes = reverse_complement_codes(codes)
            reads.append(codes)
    return reads


def phase_assembly_small(counters, device="cuda"):
    """De-novo assembly on the reference's legacy row (the first 30 kb of
    bench.py's repeat genome, 15x of 2.5 kb reads, 1% error with indels) on
    `device`, with the reference's gates; the ploidy-2 assembly of the
    diploid test input; Assembler and AssemblyGraphStatistics through the
    CLI; SIH through the CLI on phase 6's 50 kb calls and alignments
    (at least one block).  The CPU side runs as CLI subprocesses in the
    background meanwhile: its contigs must equal the card's, in process and
    through the CLI, base for base and byte for byte.  Returns (the
    launches, a function that waits for the CPU side and holds it to the
    card's outputs), so that later phases run while the CPU side ends."""
    from concurrent.futures import ThreadPoolExecutor

    from ngsepcore_tpu_torch.assembly.assembler import Assembler
    from ngsepcore_tpu_torch.core.sequences import RawRead, decode_dna
    from ngsepcore_tpu_torch.io.fasta import load_fasta
    from ngsepcore_tpu_torch.io.fastq import write_fastq
    from ngsepcore_tpu_torch.io.sam import ReadAlignmentFileWriter
    from ngsepcore_tpu_torch.vcf.io import VCFFileWriter

    L = 30_000
    codes = _bench_genome_codes()
    reads = _sim_asm_reads(codes, L, 15, 2500)
    dreads = _diploid_reads()
    seqs = lambda contigs: [(c.name, decode_dna(c.codes)) for c in contigs]
    tmp, pool = tempfile.TemporaryDirectory(), ThreadPoolExecutor(2)
    d = tmp.name
    fq = {}
    for name, rs in (("asm", reads), ("dip", dreads)):
        fq[name] = os.path.join(d, f"{name}.fastq")
        write_fastq([RawRead(name=f"r{i}", sequence=decode_dna(c), qualities="I" * len(c))
                     for i, c in enumerate(rs)], fq[name])
    out = lambda name, dev: os.path.join(d, f"{name}_{dev}")

    def cpu_side(name, extra):
        t = _cli_plain(["Assembler"] + extra + [fq[name], out(name, "cpu")], "cpu", threads=3)
        stats = _cli_plain(["AssemblyGraphStatistics", out(name, "cpu") + "_contigs.fa"],
                         "cpu")[1]
        return t[0], stats

    cpu = {"asm": pool.submit(cpu_side, "asm", []),
           "dip": pool.submit(cpu_side, "dip", ["-ploidy", "2"])}
    reset_counts(counters)
    t0 = time.perf_counter()
    got = Assembler(device=device).assemble(reads)
    sync(device)
    t_dev = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    st = _asm_stats(got, codes, L)
    log(f"phase 16 assembly legacy row ({len(reads)} reads of 2.5 kb, 30 kb): "
        f"{st['n_contigs']} contigs, N50 {st['n50']} (n50_frac {st['n50_frac']:.4f}), "
        f"anchored identity {st['identity']:.4f} on {device} ({t_dev:.2f}s); launches "
        f"{launches} (the reference's record: 1 contig, n50_frac 0.979, identity 0.975)")
    if st["n50_frac"] < 0.9 or st["identity"] < 0.95:
        fail(f"assembly gates (n50_frac >= 0.9, identity >= 0.95) missed: {st}")
    if device == "cuda" and min(launches.values()) == 0:
        fail(f"the assembly did not launch every kernel: {launches}")
    t0 = time.perf_counter()
    dgot = seqs(Assembler(ploidy=2, polish_rounds=1, device=device).assemble(dreads))
    names = [n for n, _ in dgot]
    log(f"  ploidy 2 ({len(dreads)} reads of 3 kb, two 20 kb haplotypes): contigs {names} "
        f"({time.perf_counter() - t0:.2f}s on {device})")
    if not any("hap0" in n for n in names) or not any("hap1" in n for n in names):
        fail("the ploidy-2 assembly lacks a haplotype")
    t_cli, _, _ = _cli_plain(["Assembler", fq["asm"], out("asm", device)], device)
    stats = _cli_plain(["AssemblyGraphStatistics", out("asm", device) + "_contigs.fa"],
                     device)[1]
    # SIH on phase 6's 50 kb sample: its calls and alignments on the card
    genome, sreads = _simulate_50kb()
    sam, records, _ = _run_classic(genome, sreads, device)
    with open(os.path.join(d, "s1.sam"), "w") as fh:
        ReadAlignmentFileWriter(genome.sequences, fh, sample_id="s1")
        fh.write("".join(line + "\n" for line in sam))
    with VCFFileWriter(os.path.join(d, "s1.vcf"), ["s1"]) as w:
        for r in records:
            w.write(r)
    sih = _cli_plain(["SIH", "-i", os.path.join(d, "s1.vcf"), "-b", os.path.join(d, "s1.sam"),
                    "-o", os.path.join(d, "phased.vcf")], device)[2]
    summary = [l for l in sih.splitlines() if l.startswith("Phased")]
    log(f"  CLI SIH on phase 6's {len(records)} records and {len(sam)} alignments: {summary}")
    blocks = int(summary[0].split(" in ")[1].split()[0]) if summary else 0
    if blocks < 1:
        fail("SIH phased no block on the 50 kb sample")
    log(f"  CLI Assembler {device} {t_cli:.2f}s; AssemblyGraphStatistics {stats.split()}")

    def finish():
        t_cpu, stats_cpu = cpu["asm"].result()
        t_dip, _ = cpu["dip"].result()
        pool.shutdown()
        fa = {dev: open(out("asm", dev) + "_contigs.fa").read() for dev in (device, "cpu")}
        equal = {
            "in process": seqs(got) == seqs(load_fasta(out("asm", "cpu") + "_contigs.fa")),
            "ploidy 2": dgot == seqs(load_fasta(out("dip", "cpu") + "_contigs.fa")),
            "CLI contigs": fa[device] == fa["cpu"], "CLI statistics": stats == stats_cpu,
        }
        tmp.cleanup()
        log(f"phase 16 assembly on the CPU (CLI subprocesses, 3 threads each, in the "
            f"background): legacy row {t_cpu:.2f}s, ploidy 2 {t_dip:.2f}s; {device} equal to "
            f"the CPU: {equal}")
        if not all(equal.values()):
            fail(f"assembly outputs differ between {device} and the CPU: {equal}")

    return launches, finish


# phase 17's inputs: bench_configs.py's assembler scale row A (60x of 15 kb
# reads over 300 kb) and its 100 kb linearity row (30x of 10 kb).  Row A
# alone took 239.6 s on an H100 (asm.merge 129 s, asm.polish 100 s: host
# Python), at the 240 s the script can give it, so the script runs the
# linearity row unless --asm-row A asks for row A
ASM_ROWS = {
    "A": dict(L=300_000, cov=60, rl=15_000, tag="scale row A (bench_configs.py:341)"),
    "lin100": dict(L=100_000, cov=30, rl=10_000,
                   tag="linearity row 100 kb (bench_configs.py:351)"),
}


def phase_assembly_real_size(counters, row="lin100", device="cuda"):
    """Assembly at user size, on the card only: ASM_ROWS[row]'s reads
    through Assembler() defaults; one synchronised wall time, genome
    bases/s, contigs, N50, n50_frac, anchored identity (gate >= 0.90), the
    asm.* and lr.* stage times, Gotoh and walk launches by shape (rows
    summed), peak memory.  The 100 kb row's contigs, as save_fasta writes
    them, are held to the JAX package's CPU contigs (PHASE17_CONTIGS); row A
    is held by its gates only (the JAX package's CPU side would take
    hours)."""
    import torch

    from ngsepcore_tpu_torch.assembly.assembler import Assembler
    from ngsepcore_tpu_torch.io.fasta import save_fasta
    from ngsepcore_tpu_torch.utils import profiling

    ASM_ROW = ASM_ROWS[row]
    L, cov, rl = ASM_ROW["L"], ASM_ROW["cov"], ASM_ROW["rl"]
    codes = _bench_genome_codes()
    t0 = time.perf_counter()
    reads = _sim_asm_reads(codes, L, cov, rl)
    bases = sum(len(r) for r in reads)
    log(f"phase 17 inputs, {ASM_ROW['tag']}: {len(reads)} reads, {bases} bases over the first "
        f"{L} bp ({time.perf_counter() - t0:.1f}s)")
    torch.cuda.reset_peak_memory_stats()
    profiling.enable()
    profiling.reset()
    reset_counts(counters)
    sync(device)
    t0 = time.perf_counter()
    contigs = Assembler(device=device).assemble(reads)
    sync(device)
    dt = time.perf_counter() - t0
    profiling.enable(False)
    launches = {c.__name__: c.launches for c in counters}
    gotoh_shapes = _long_read_gotoh_shapes(counters[0])
    walk_shapes = Counter(counters[1].launch_shapes)
    peak = torch.cuda.max_memory_allocated()
    st = _asm_stats(contigs, codes, L)
    log(f"  assembly {dt:.3f}s = {L / dt:.1f} genome bases/s; {st['n_contigs']} contigs, N50 "
        f"{st['n50']}, n50_frac {st['n50_frac']:.4f}, anchored identity {st['identity']:.4f}; "
        f"peak device memory {peak / 2**20:.1f} MiB; launches {launches}")
    for name, (total, calls) in sorted(profiling._stages.items(), key=lambda kv: -kv[1][0]):
        print(f"  stage {name:<28} {total:9.3f}s x{calls}", flush=True)
    by, rows = Counter(), Counter()
    for (kind, B, Lq, Ls, kern), n in gotoh_shapes.items():
        by[kind, Lq, Ls, kern] += n
        rows[kind, Lq, Ls, kern] += n * B
    log("  gotoh launches by (kind, Lq, Ls, kernel): " + ", ".join(
        f"{n} x {k} ({rows[k]} rows)" for k, n in sorted(by.items(), key=lambda kv: -kv[1])))
    by, rows = Counter(), Counter()
    for (mode, B, Lq, Ls, R, fs2), n in walk_shapes.items():
        by[mode, Lq, Ls, R, fs2] += n
        rows[mode, Lq, Ls, R, fs2] += n * B
    log("  walk launches by (mode, Lq, Ls, R, free_start2): " + ", ".join(
        f"{n} x {k} ({rows[k]} rows)" for k, n in sorted(by.items(), key=lambda kv: -kv[1])))
    with tempfile.TemporaryDirectory() as d:
        save_fasta(contigs, os.path.join(d, "contigs.fa"))
        digest = fasta_digest(os.path.join(d, "contigs.fa"))
    log(f"  contigs digest {digest}" + (
        f"; the JAX package's on the CPU {PHASE17_CONTIGS}" if row == "lin100" else ""))
    if st["identity"] < 0.90:
        fail(f"assembly identity {st['identity']} below the 0.90 gate")
    if min(launches.values()) == 0:
        fail(f"the assembly did not launch every kernel: {launches}")
    walk_route(counters, "hamming", "phase 17, assembly")
    if row == "lin100" and digest != PHASE17_CONTIGS:
        fail(f"phase 17: the contigs {digest} are not the JAX package's {PHASE17_CONTIGS}")
    return launches, gotoh_shapes, walk_shapes


# ---------------------------------------------------------------------------
# The imputer's forward-backward kernel (csrc/forward_backward.cu), phase 2d.
# The f64 units its work is made of, at full load: kind 1 runs
# x = exp10(x - 1.0) (10^(v - m); x stays in [0.1, 1]), kind 2
# x = log10(x) + 10.0 (m + log10(s); x stays near 11.04), eight independent
# chains a thread and four blocks of 256 threads an SM; each block stores its
# SM and that SM's clock at its start and end.
FB_RATE_CU = r"""
#include <cuda_runtime.h>

namespace {
constexpr int kChains = 8;

__device__ __forceinline__ long long stamp() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

template <int kKind>
__global__ void __launch_bounds__(256) fb_rate_kernel(const double* __restrict__ in, int reps,
                                                      long long* span, double* sink) {
  double x[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) x[k] = in[(threadIdx.x + k) & 31];
  __syncthreads();
  const long long t0 = stamp();
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if (kKind == 1) x[k] = exp10(x[k] - 1.0);
      else x[k] = log10(x[k]) + 10.0;
    }
  }
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += x[k];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
  __syncthreads();
  const long long t1 = stamp();
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    span[3 * blockIdx.x] = sm;
    span[3 * blockIdx.x + 1] = t0;
    span[3 * blockIdx.x + 2] = t1;
  }
}
}  // namespace

extern "C" int fb_rate(int kind, const void* in, int blocks, int reps, void* span, void* sink) {
  const double* i = (const double*)in;
  long long* sp = (long long*)span;
  double* s = (double*)sink;
  if (kind == 1) fb_rate_kernel<1><<<blocks, 256>>>(i, reps, sp, s);
  else fb_rate_kernel<2><<<blocks, 256>>>(i, reps, sp, s);
  return (int)cudaGetLastError();
}
"""
FB_RATE_CHAINS = 8
FP64_OPS_PER_S = 132 * 64 * 1.98e9  # 16.7 T f64 lane instructions/s (H100 SXM)
# the FP64 tensor cores' dense peak (NVIDIA H100 SXM data sheet: 67 TFLOP/s)
FP64_TENSOR_FLOPS = 67e12


def fb_rates(reps: int = 1024) -> dict:
    """FP64 lane cycles (an SM's cycles x its 64 FP64 lanes) of one exp10(x
    - c) and of one log10(x) + c at full load on this card (FB_RATE_CU,
    built into the package's build directory): what each costs where
    nothing waits, whatever ptxas made of it and whichever way its range
    checks branch.  Per SM: its clock between its first block's start and
    its last block's end, over the units its blocks ran; the median of the
    SMs, the least of three launches."""
    import ctypes

    import torch

    from ngsepcore_tpu_torch.kernels import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / "fb_rate.cu"
    src.write_text(FB_RATE_CU)
    lib, _ = cuda_build.build([src], stem="libfb_rate")
    fn = lib.fb_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    inp = torch.from_numpy(np.random.default_rng(1).random(32) * 0.9 + 0.1).cuda()
    span = torch.zeros((blocks, 3), dtype=torch.int64, device="cuda")
    sink = torch.empty(blocks * 256, dtype=torch.float64, device="cuda")
    out = {}
    for kind, name in ((1, "exp10"), (2, "log10")):
        best = float("inf")
        for _ in range(3):
            cuda_build.check("fb_rate", fn(kind, inp.data_ptr(), blocks, reps, span.data_ptr(),
                                           sink.data_ptr()))
            torch.cuda.synchronize()
            by_sm = {}
            for sm, t0, t1 in span.cpu().numpy().tolist():
                by_sm.setdefault(sm, []).append((t0, t1))
            lanes = [64 * (max(t for _, t in ts) - min(t for t, _ in ts))
                     / (len(ts) * 256 * FB_RATE_CHAINS * reps) for ts in by_sm.values()]
            best = min(best, float(np.median(lanes)))
        out[name] = best
    if not bool(torch.isfinite(sink).all()):
        fail("the exp10 / log10 rate kernel left a non-finite value")
    return out


def fb_bound(n: int, T: int, S: int, per_step: bool, lat: dict, rate: dict):
    """(bound_ms, bound_by, terms in ms) of one posterior_log_batch launch:
    the least time the card could take for the function, in any design.
    The transitions are shared by every sample of a step and the imputer's
    are finite (log10 above about -14), so each step of each pass can be an
    (n x S) x (S x S) product of probabilities scaled by a maximum, with
    10^ and log10 only where values enter and leave log10.  Terms:
    - bytes: emissions read and posteriors written once (16 n T S), the
      transitions, start and ll, over HBM's rate;
    - products: 2 (T-1) n S^2 f64 multiply-adds on the FP64 tensor cores;
    - fp64, beside them on the FP64 lanes: 10^(e - m) of every emission and
      10^M of every transition entry, log10(p) + c of every posterior, at
      fb_rates' lane cycles (the smaller elementwise work is left out: it
      only lowers the floor);
    - chain: each pass's T-1 dependent steps, each a shared-memory exchange
      of the previous step's S values and a tree of 1 + ceil(log2 S)
      dependent f64 adds (viterbi_latencies' links), at 1.98 GHz.
    Also `per_cell_form`, not part of the bound: the f64 lane time of the
    log-space form the kernel runs, 2 (T-1) n S^2 cells of an add, a
    compare, an exp10(x - m) and an add into the sum."""
    import math

    n_trans = (T - 1) if per_step else 1
    cells = 2 * (T - 1) * n * S * S
    lanes = (n * T * S + n_trans * S * S) * rate["exp10"] + n * T * S * rate["log10"]
    link = lat["smem"] + (1 + math.ceil(math.log2(S))) * lat["dadd"]
    terms = {
        "bytes": (16 * n * T * S + 8 * n_trans * S * S + 8 * S + 8 * n) / HBM_BYTES_PER_S * 1e3,
        "products": 2 * cells / FP64_TENSOR_FLOPS * 1e3,
        "fp64": lanes / FP64_OPS_PER_S * 1e3,
        "chain": 2 * (T - 1) * link / SM_CLOCK_HZ * 1e3,
        "per_cell_form": cells * (3 + rate["exp10"]) / FP64_OPS_PER_S * 1e3,
    }
    # the tensor cores and the FP64 lanes issue side by side
    ms, by = max((terms["bytes"], "bytes"),
                 (max(terms["products"], terms["fp64"]), "operations"),
                 (terms["chain"], "operations"))
    return ms, by, terms


def _fb_batch(rng, n, T, S, per_step=False, neg_inf=False, dead_state=False):
    """n sequences of T steps sharing a random log10 HMM of S states
    (tests/test_torch_hmm.py's _fb_batch)."""
    start, trans, _ = _random_hmm(rng, T, S, per_step, neg_inf)
    emit = np.log10(rng.random((n, T, S)))
    if dead_state:  # no start and no transition reaches state S-1
        start[-1] = -np.inf
        trans[:, :, -1] = -np.inf
    return start, trans, emit


def _imputer_window(rng, n, T, K, missing=0.2):
    """The imputer's E-step input at n samples x T sites, K clusters: log
    start, per-step transitions of random SNV spacing and emissions of
    random theta and dosages (GenotypeImputer._impute_window's)."""
    import torch

    from ngsepcore_tpu_torch.imputation.genotype_imputer import (
        _diploid_emissions, _transition_matrix)

    positions = np.sort(rng.choice(10_000_000, size=T, replace=False))
    d_morgans = 0.001 * np.maximum(np.diff(positions), 1) / 1000.0 / 100.0
    recomb_p = np.clip(1.0 - np.exp(-d_morgans), 1e-6, 0.49)
    trans = torch.from_numpy(_transition_matrix(recomb_p, K)).cuda()
    start = torch.full((K * K,), -np.log10(K * K), dtype=torch.float64, device="cuda")
    theta = torch.from_numpy(np.clip(rng.random((T, K)), 1e-3, 1 - 1e-3)).cuda()
    dos = rng.integers(0, 3, size=(n, T)).astype(np.int8)
    dos[rng.random((n, T)) < missing] = -1
    emit = _diploid_emissions(theta, torch.from_numpy(dos).cuda())
    return start, trans, emit


FB_POST_TOL = 1e-9  # log10 posteriors, absolute: exp10 against torch.pow, sums in another order
FB_LL_RTOL = 1e-12  # log-likelihoods, relative: they grow with T
# phase 19's confidence sum, relative: each confidence within FB_POST_TOL in log10
PHASE19_CONF_RTOL = float(np.log(10)) * FB_POST_TOL


def _fb_disagreement(got, want):
    """(max abs error of the posteriors, max relative error of ll, -inf
    patterns equal) of (post, ll) pairs."""
    import torch

    post, ll = got
    wpost, wll = want
    same_inf = bool(torch.equal(torch.isneginf(post), torch.isneginf(wpost)))
    fin = torch.isfinite(wpost)
    err = float((post[fin] - wpost[fin]).abs().max()) if bool(fin.any()) else 0.0
    rel = float(((ll - wll).abs() / wll.abs().clamp(min=1.0)).max())
    return err, rel, same_inf


def _fb_at(args, samples: int):
    """The log form with `samples` sequences a block: FB_BLOCK_THREADS set
    for the call to the threads they take (layouts the default block does
    not give; the layout changes no arithmetic)."""
    from ngsepcore_tpu_torch.kernels import hmm

    keep = hmm.FB_BLOCK_THREADS
    hmm.FB_BLOCK_THREADS = samples * ((args[2].shape[-1] + 31) // 32 * 32)
    try:
        return hmm.posterior_log_batch(*args, form="log")
    finally:
        hmm.FB_BLOCK_THREADS = keep


def _fb_routed(args, rows=None):
    """posterior_log_batch as a caller makes it (the form by its
    precondition), the product form at `rows` samples a block where it
    takes it: (post, ll, the form the call took)."""
    from ngsepcore_tpu_torch.kernels import hmm

    before = dict(hmm.posterior_log_batch.launches_by_form)
    keep = hmm.FB_PRODUCT_ROWS
    hmm.FB_PRODUCT_ROWS = rows
    try:
        post, ll = hmm.posterior_log_batch(*args)
    finally:
        hmm.FB_PRODUCT_ROWS = keep
    took = [f for f, k in hmm.posterior_log_batch.launches_by_form.items() if k != before[f]]
    return post, ll, took[0] if len(took) == 1 else took


def phase_forward_backward():
    """The forward-backward kernel against the batched plain loop on the
    card (S 1 to 1,024, shared and per-step transitions, a dead state, -inf
    transitions, emissions past the product form's range, T 1, n 1 to 64):
    each case must take the form its precondition names (fb_form) and agree
    in it, the product form at 8 and 16 samples a block, and the log form
    at 1 to 32 samples a block on every case.  Then both forms' times at
    the imputer's shape (n 300, T 5,000, S 64) beside the floor of the
    function (fb_bound) and the plain loop's time.  fb_bench.py has the
    same-card A/B at other batch sizes and the ablations."""
    import torch

    from ngsepcore_tpu_torch.kernels.hmm import (
        posterior_log_batch, posterior_log_batch_ref)

    lat = viterbi_latencies()
    rate = fb_rates()
    log(f"phase 2d forward-backward units at full load, f64 lane cycles: exp10(x - c) "
        f"{rate['exp10']:.3f}, log10(x) + c {rate['log10']:.3f}; links, cycles: DADD "
        f"{lat['dadd']:.2f}, shared memory {lat['smem']:.2f}")
    rng = np.random.default_rng(12)
    P, Lg = "product", "log"
    cases = [
        ("S1 n1", 1, P, _fb_batch(rng, 1, 50, 1)),
        ("S4 shared n8", 1, P, _fb_batch(rng, 8, 500, 4)),
        ("S4 per-step n5, 32 a block", 32, P, _fb_batch(rng, 5, 300, 4, per_step=True)),
        ("S16 per-step -inf, dead state n16", 1, Lg,
         _fb_batch(rng, 16, 200, 16, per_step=True, neg_inf=True, dead_state=True)),
        ("S16 shared n9, 8 a block", 8, P, _fb_batch(rng, 9, 150, 16)),
        ("S64 shared n3", 1, P, _fb_batch(rng, 3, 100, 64)),
        ("S64 T1 n4", 1, P, _fb_batch(rng, 4, 1, 64, per_step=True)),
        ("S64 per-step dead state n7, 4 a block", 4, Lg,
         _fb_batch(rng, 7, 60, 64, per_step=True, dead_state=True)),
        ("S128 per-step n2 (tile in chunks)", 1, Lg, _fb_batch(rng, 2, 30, 128, per_step=True)),
        ("S1024 shared n2", 1, Lg, _fb_batch(rng, 2, 8, 1024)),
        ("S1024 per-step n1", 1, Lg, _fb_batch(rng, 1, 5, 1024, per_step=True)),
        ("S12 per-step n21", 2, P, _fb_batch(rng, 21, 70, 12, per_step=True)),
    ]
    start, trans, emit = _fb_batch(rng, 4, 40, 16)
    emit[:, :, 1::2] = -300.0  # R_E = 300: 3 R_E is past the product form's 250 decades
    cases.append(("S16 past the range n4", 1, Lg, (start, trans, emit)))
    cases = [(name, g, form, tuple(torch.from_numpy(a).cuda() for a in arrays))
             for name, g, form, arrays in cases]
    cases.append(("imputer S64 n64 T400", 1, P, _imputer_window(rng, 64, 400, 8)))
    start, trans, emit = cases[1][3]  # S4 shared n8, its emissions as a strided view
    cases.append(("S4 shared n8, strided emissions", 1, P,
                  (start, trans, emit.transpose(0, 1).contiguous().transpose(0, 1))))
    worst = [0.0, 0.0]
    for name, g, form, args in cases:
        want = posterior_log_batch_ref(*args)
        runs = [(f"{form} form" + (f", {rows} a block" if form == P else ""),
                 _fb_routed(args, rows)) for rows in ((8, 16) if form == P else (None,))]
        if form == P:  # the log form answers every input
            runs.append((f"log form, {g} a block", _fb_at(args, g) + ("log",)))
        for label, (post, ll, took) in runs:
            torch.cuda.synchronize()
            err, rel, same_inf = _fb_disagreement((post, ll), want)
            log(f"phase 2d forward-backward {name}, {label}: took the {took} form; max |post "
                f"error| {err:.3e}, ll relative {rel:.3e}, -inf entries equal {same_inf}")
            if took != label.split()[0]:
                fail(f"the forward-backward call took the {took} form on {name}, not {form}")
            if err > FB_POST_TOL or rel > FB_LL_RTOL or not same_inf:
                fail(f"the forward-backward kernel disagrees with its plain version on {name} "
                     f"({label})")
            worst = [max(worst[0], err), max(worst[1], rel)]

    # the imputer's shape: one window of NGSEP's defaults
    n, T, K = 300, 5000, 8
    args = _imputer_window(rng, n, T, K)
    S = K * K
    post, ll, took = _fb_routed(args)
    torch.cuda.synchronize()
    if took != P:
        fail(f"the imputer's window took the {took} form, not the product form")
    t0 = time.perf_counter()
    want = posterior_log_batch_ref(*args)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    err, rel, same_inf = _fb_disagreement((post, ll), want)
    log_err = _fb_disagreement(posterior_log_batch(*args, form="log"), want)
    del post, ll, want
    for label, (e, r, same) in (("product", (err, rel, same_inf)), ("log", log_err)):
        if e > FB_POST_TOL or r > FB_LL_RTOL or not same:
            fail(f"the {label} form disagrees with its plain version at the imputer's shape")
    worst = [max(worst[0], err, log_err[0]), max(worst[1], rel, log_err[1])]
    times = {}
    for form in (P, Lg):
        fn = lambda form=form: posterior_log_batch(*args, form=form)
        times[form] = (cuda_ms(fn, reps=3, calls=3), graph_ms(fn, calls=3, reps=3))
    least = float(args[1][torch.isfinite(args[1])].min())
    b_ms, b_by, terms = fb_bound(n, T, S, True, lat, rate)
    (ms, gms), (log_ms, log_gms) = times[P], times[Lg]
    log(f"  time n={n} T={T} S={S} (per-step transitions, least log10 entry {least:.3f}): "
        f"product form {ms:.4f} ms (median of 3 x 3 calls), graph {gms:.4f} ms; log form "
        f"{log_ms:.4f} ms, graph {log_gms:.4f} ms; plain loop {plain:.1f} ms (one call); floor "
        f"{b_ms:.4f} ms by {b_by} (terms, ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in terms.items() if k != "per_cell_form")
        + f"); product form at {100 * b_ms / gms:.2f}% of it, log form at "
        f"{100 * b_ms / log_gms:.2f}%; the log form's per-cell form alone "
        f"{terms['per_cell_form']:.3f} ms of f64 lanes; errors against the plain loop: product "
        f"post {err:.3e}, ll relative {rel:.3e}; log post {log_err[0]:.3e}, ll relative "
        f"{log_err[1]:.3e}")
    return dict(ms=ms, graph_ms=gms, log_form_ms=log_ms, log_form_graph_ms=log_gms,
                plain_ms=plain, max_abs_err=worst[0], bound_ms=b_ms, bound_by=b_by,
                shape=f"n={n} T={T} S={S}", bound_terms_ms=terms, fp64_lane_cycles=rate)


# ---------------------------------------------------------------------------
# The imputer (phases 18, 19)

def _simulate_population(n_samples=40, n_sites=300, k_haps=4, seed=3):
    """tests/test_imputation.py's population (a copy: the tests import jax),
    drawn in its order."""
    rng = np.random.default_rng(seed)
    founders = rng.integers(0, 2, size=(k_haps, n_sites)).astype(np.int8)
    positions = np.sort(rng.choice(10_000_000, size=n_sites, replace=False))

    def sample_haplotype():
        hap = np.empty(n_sites, np.int8)
        cur = rng.integers(0, k_haps)
        for t in range(n_sites):
            if rng.random() < 0.01:
                cur = rng.integers(0, k_haps)
            hap[t] = founders[cur, t]
        return hap

    genotypes = np.stack(
        [sample_haplotype() + sample_haplotype() for _ in range(n_samples)]
    ).astype(np.int8)
    return genotypes, positions


def _simulate_mosaics(n_samples, n_sites, k_haps=8, switch=0.01, span=10_000_000, seed=19):
    """_simulate_population vectorised: every haplotype a mosaic of k_haps
    founders, switching to a random founder with probability `switch` a
    site; SNVs at distinct random positions of a `span` bp chromosome."""
    rng = np.random.default_rng(seed)
    founders = rng.integers(0, 2, size=(k_haps, n_sites)).astype(np.int8)
    positions = np.sort(rng.choice(span, size=n_sites, replace=False)) + 1
    H = 2 * n_samples
    draws = rng.integers(0, k_haps, size=(H, n_sites))
    switches = rng.random((H, n_sites)) < switch
    switches[:, 0] = True
    last = np.maximum.accumulate(np.where(switches, np.arange(n_sites), 0), axis=1)
    haps = founders[np.take_along_axis(draws, last, axis=1), np.arange(n_sites)[None, :]]
    return (haps[0::2] + haps[1::2]).astype(np.int8), positions, rng


def _write_population_vcf(path, genotypes, positions, mask):
    """tests/test_imputation.py::test_imputation_vcf_roundtrip's VCF."""
    from ngsepcore_tpu_torch.variants.model import CalledGenomicVariant
    from ngsepcore_tpu_torch.vcf.io import VCFFileWriter, VCFRecord

    samples = [f"s{i}" for i in range(genotypes.shape[0])]
    with VCFFileWriter(path, samples) as w:
        for t in range(genotypes.shape[1]):
            calls = []
            for s in range(genotypes.shape[0]):
                g = int(genotypes[s, t])
                idxs = [] if mask[s, t] else ([0, 0] if g == 0 else [0, 1] if g == 1 else [1, 1])
                calls.append(CalledGenomicVariant(
                    sequence_name="chr1", first=int(positions[t]), alleles=["A", "C"],
                    sample_id=samples[s], indexes_called_alleles=idxs, genotype_quality=60))
            w.write(VCFRecord(variant=calls[0], calls=calls))


def _vcf_file_body(path):
    with open(path) as fh:
        return [line for line in fh if not line.startswith("#")]


def phase_imputer_small(device="cuda"):
    """Phase 18: tests/test_imputation.py's two workloads on `device`
    against the CPU, in process and through the CLI (VCFImpute), then the
    VCF downstream commands on the imputed VCF: outputs identical."""
    import contextlib
    import io as _io

    import torch

    from ngsepcore_tpu_torch.__main__ import main as port_main
    from ngsepcore_tpu_torch.imputation.genotype_imputer import GenotypeImputer
    from ngsepcore_tpu_torch.kernels.hmm import posterior_log_batch

    genotypes, positions = _simulate_population()
    mask = np.random.default_rng(7).random(genotypes.shape) < 0.15
    observed = genotypes.copy()
    observed[mask] = -1
    runs = {}
    for dev in (device, "cpu"):
        before = posterior_log_batch.launches
        runs[dev] = GenotypeImputer(k=4, window_size=400, n_iterations=15, seed=2,
                                    device=dev).impute_matrix(observed, positions)
        if dev == "cuda" and posterior_log_batch.launches - before != 16:
            fail("the 40 x 300 imputation did not make one kernel launch an E-step (16)")
    (imp, conf), (imp_c, conf_c) = runs[device], runs["cpu"]
    acc = float(np.mean(imp[mask] == genotypes[mask]))
    conf_err = float(np.abs(conf - conf_c).max())
    log(f"phase 18 imputer 40 x 300 (k 4, 15 iterations): dosages equal "
        f"{np.array_equal(imp, imp_c)}, max |conf error| {conf_err:.3e}, masked accuracy "
        f"{acc:.4f}")
    if not np.array_equal(imp, imp_c) or conf_err > 1e-9 or acc <= 0.9:
        fail("the 40 x 300 imputation differs between CUDA and the CPU (or misses 0.9)")

    d = tempfile.mkdtemp(prefix="impute_")
    try:
        genotypes, positions = _simulate_population(n_samples=10, n_sites=60)
        mask = np.random.default_rng(1).random(genotypes.shape) < 0.2
        vcf = os.path.join(d, "pop.vcf")
        _write_population_vcf(vcf, genotypes, positions, mask)
        for dev, tag in ((device, "dev"), ("cpu", "ref")):
            GenotypeImputer(k=4, window_size=100, n_iterations=8, seed=5, device=dev).run(
                vcf, os.path.join(d, f"run_{tag}"))
        body = _vcf_file_body(os.path.join(d, "run_dev_imputed.vcf"))
        if body != _vcf_file_body(os.path.join(d, "run_ref_imputed.vcf")) or len(body) != 60:
            fail("GenotypeImputer.run's VCF differs between CUDA and the CPU")
        j = lambda *a: os.path.join(d, *a)
        sizes = _cli_pairs({"VCFImpute": (
            ["VCFImpute", "-i", vcf, "-o", j("cli_{dev}"), "-k", "4", "-w", "100", "-t", "8",
             "-seed", "5"], [j("cli_{dev}_imputed.vcf")])}, device)
        if _vcf_file_body(j("cli_dev_imputed.vcf")) != body:
            fail("VCFImpute through the CLI differs from GenotypeImputer.run")
        imputed = j("cli_dev_imputed.vcf")
        with open(j("regions.txt"), "w") as fh:
            fh.write("chr1\t1\t2000000\n")
        formats = ("Matrix,Fasta,Plink,Structure,Hapmap,rrBLUP,Emma,Eigensoft,Darwin,Flapjack,"
                   "Phase,GWASPoly,Spagedi,PowerMarker,Haploview")
        jobs = {
            "VCFFilter": (["VCFFilter", "-i", imputed, "-o", j("filter_{dev}.vcf"), "-q", "10",
                           "-minMAF", "0.05", "-frs", j("regions.txt")], [j("filter_{dev}.vcf")]),
            "VCFSummaryStats": (["VCFSummaryStats", "-i", imputed, "-o", j("summary_{dev}.txt")],
                                [j("summary_{dev}.txt")]),
            "VCFDistanceMatrixCalculator": (
                ["VCFDistanceMatrixCalculator", "-i", imputed, "-o", j("dist_{dev}.txt")],
                [j("dist_{dev}.txt")]),
            "VCFConverter": (["VCFConverter", "-i", imputed, "-o", j("conv_{dev}"), "-f",
                              formats], [j("conv_{dev}_genotypes.txt"), j("conv_{dev}.ped"),
                                         j("conv_{dev}_aln.fa"), j("conv_{dev}_GWASPoly.csv")]),
        }
        sizes.update(_cli_pairs(jobs, device))
        sizes.update(_cli_pairs({"NeighborJoining": (
            ["NeighborJoining", "-i", j("dist_{dev}.txt"), "-o", j("nj_{dev}.nwk")],
            [j("nj_{dev}.nwk")])}, device))
        outs = []
        for dev in (device, "cpu"):
            buf = _io.StringIO()
            with contextlib.redirect_stdout(buf):
                port_main(["--device", dev, "VCFComparator", imputed, vcf])
            outs.append(buf.getvalue())
        if outs[0] != outs[1] or "Concordance" not in outs[0]:
            fail("VCFComparator differs between CUDA and the CPU")
        log(f"  10 x 60 VCF: GenotypeImputer.run and VCFImpute equal on CUDA and the CPU; "
            f"VCFFilter, VCFSummaryStats, VCFDistanceMatrixCalculator -> NeighborJoining, "
            f"VCFConverter ({formats.count(',') + 1} formats), VCFComparator equal (bytes: "
            f"{sizes}); comparator: {' '.join(outs[0].split())}")
    finally:
        import shutil

        shutil.rmtree(d, ignore_errors=True)


IMPUTE_SAMPLES, IMPUTE_SITES = 300, 20_000  # phase 19


def phase_imputer_real_size(device="cuda"):
    """Phase 19: 300 samples x 20,000 biallelic SNVs (mosaics of 8 founder
    haplotypes, 20% of the genotypes masked) imputed at NGSEP's defaults
    (k 8, window 5,000, overlap 50, 10 iterations: 5 windows, 55 kernel
    launches), with the JAX test's gate: masked accuracy >= 0.9; the first
    window's dosages and confidence sum against the JAX package's
    (PHASE19_WINDOW1)."""
    import torch

    from ngsepcore_tpu_torch.imputation.genotype_imputer import GenotypeImputer
    from ngsepcore_tpu_torch.kernels.hmm import posterior_log_batch

    genotypes, positions, rng = _simulate_mosaics(IMPUTE_SAMPLES, IMPUTE_SITES)
    mask = rng.random(genotypes.shape) < 0.2
    observed = genotypes.copy()
    observed[mask] = -1
    imp = GenotypeImputer(k=8, window_size=5000, overlap=50, n_iterations=10, seed=1,
                          device=device)
    spent = Counter()

    def timed(name, fn):
        def run(*a):
            sync(device)
            t0 = time.perf_counter()
            out = fn(*a)
            sync(device)
            spent[name] += time.perf_counter() - t0
            return out
        return run

    # the E-step and M-step on the device; each window's transitions built
    # on the host and uploaded, the posteriors' copy to the host and the
    # genotype posterior's einsum there
    stages = ("e_step", "m_step", "window_model", "posteriors_to_host", "genotype_posteriors")
    for name in stages:
        setattr(imp, name, timed(name, getattr(imp, name)))
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    posterior_log_batch.launches = 0
    for form in posterior_log_batch.launches_by_form:
        posterior_log_batch.launches_by_form[form] = 0
    t0 = time.perf_counter()
    imputed, conf = imp.impute_matrix(observed, positions)
    sync(device)
    wall = time.perf_counter() - t0
    launches = posterior_log_batch.launches
    by_form = dict(posterior_log_batch.launches_by_form)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    acc = float(np.mean(imputed[mask] == genotypes[mask]))
    log(f"phase 19 imputer {IMPUTE_SAMPLES} x {IMPUTE_SITES} (k 8, window 5000, overlap 50, "
        f"10 iterations): wall {wall:.3f} s: " + ", ".join(f"{k} {spent[k]:.3f} s" for k in stages)
        + f", the rest {wall - sum(spent.values()):.3f} s; kernel launches {launches} {by_form}; "
        f"peak device memory {peak:.3f} GiB; masked accuracy {acc:.4f} over "
        f"{int(mask.sum())} genotypes; undecided left {int((imputed < 0).sum())}")
    window1 = imputed_digest(imputed, conf, PHASE19_WINDOW1[0])
    log(f"  first window {window1}; the JAX package's on the CPU {PHASE19_WINDOW1}")
    windows = -(-(IMPUTE_SITES - 50) // 4950)
    if window1[:2] != PHASE19_WINDOW1[:2] or not (
            abs(window1[2] - PHASE19_WINDOW1[2]) <= PHASE19_CONF_RTOL * PHASE19_WINDOW1[2]):
        fail(f"phase 19: the first window {window1} is not the JAX package's {PHASE19_WINDOW1} "
             f"(confidence sum within {PHASE19_CONF_RTOL:.3e} of it)")
    if on_card and (launches != 11 * windows or by_form["product"] != launches):
        fail(f"phase 19 made {launches} forward-backward launches {by_form}, not "
             f"{11 * windows} ({windows} windows x 11) all of the product form")
    if (imputed < 0).any() or acc < 0.9:
        fail(f"phase 19 masked accuracy {acc:.4f} misses the gate of 0.9")
    return dict(launches=launches, launches_by_form=by_form, wall_s=wall,
                stage_s={k: spent[k] for k in stages}, peak_gib=peak, accuracy=acc)


# ---------------------------------------------------------------------------
# Phases 20 and 21: benchmark tools, reads processing, genome comparison

AMINO = "ARNDCQEGHILKMFPSTWYV"


def protein_catalogs(rng, n_orth, n_fam, n_par=4, n_cat=3, lengths=(300, 501)):
    """n_cat catalogs, each of n_orth single-copy orthologs (5% substitutions
    from one ancestor a ortholog) and n_fam families of n_par paralogs (15%
    from one ancestor a family), each catalog in its own random order:
    [(name, protein)] a catalog.  Ortholog i is named o<i> in every catalog,
    paralog j of family f f<f>p<j>."""
    aa = np.array(list(AMINO))

    def mutate(seq, rate):
        m = rng.random(len(seq)) < rate
        out = seq.copy()
        out[m] = rng.integers(0, 20, size=int(m.sum()))
        return out

    orth = [rng.integers(0, 20, size=int(rng.integers(*lengths))) for _ in range(n_orth)]
    fams = [rng.integers(0, 20, size=int(rng.integers(*lengths))) for _ in range(n_fam)]
    cats = []
    for _ in range(n_cat):
        entries = [(f"o{i}", mutate(s, 0.05)) for i, s in enumerate(orth)]
        entries += [(f"f{f}p{j}", mutate(s, 0.15)) for f, s in enumerate(fams)
                    for j in range(n_par)]
        order = rng.permutation(len(entries))
        cats.append([(entries[i][0], "".join(aa[entries[i][1]])) for i in order])
    return cats


def write_catalogs(d, cats):
    """One FASTA a catalog, cat<c>.fa in `d`; returns the paths."""
    paths = []
    for c, entries in enumerate(cats):
        paths.append(os.path.join(d, f"cat{c}.fa"))
        with open(paths[-1], "w") as fh:
            fh.writelines(f">{name}\n{seq}\n" for name, seq in entries)
    return paths


def exact_triples(orthogroups_path) -> int:
    """Orthogroups of a CDNACatalogAligner file that hold exactly one
    ortholog o<i> from each of three catalogs, the same i."""
    n = 0
    with open(orthogroups_path) as fh:
        for line in fh:
            members = line.rstrip("\n").split("\t")[1:]
            cats = {m.split(":", 1)[0] for m in members}
            names = {m.split(":", 1)[1] for m in members}
            if len(members) == 3 and len(cats) == 3 and len(names) == 1 \
                    and next(iter(names)).startswith("o"):
                n += 1
    return n


def _random_dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def _coding(rng, codons):
    """ATG, `codons` random sense codons, a stop codon."""
    sense = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"
             if a + b + c not in ("TAA", "TAG", "TGA")]
    return "ATG" + "".join(rng.choice(sense, size=codons)) + "TAA"


def _point_mutations(rng, seq, rate):
    s = np.frombuffer(seq.encode(), np.uint8).copy()
    m = rng.random(len(s)) < rate
    s[m] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=int(m.sum()))]
    return s.tobytes().decode()


def _gene_genomes(d, rng, n_genomes=3, n_genes=10, prefix="ga"):
    """n_genomes genomes of 30 kb with the same n_genes genes at the same
    places (the later ones 2% point mutations from the first): gene 3 on
    the minus strand, gene 5 in two exons.  <prefix><g>.fa and
    <prefix><g>.gff3."""
    seq = list(_random_dna(rng, 30_000))
    genes = []  # (first, last, strand, [(cds first, cds last)])
    for i in range(n_genes):
        first = 1001 + 2800 * i
        cds = _coding(rng, 150)
        if i == 3:
            rc = {"A": "T", "C": "G", "G": "C", "T": "A"}
            cds = "".join(rc[b] for b in reversed(cds))
        if i == 5:
            exons = [(first, first + 239), (first + 340, first + 339 + len(cds) - 240)]
            seq[first - 1 : first + 239] = cds[:240]
            seq[first + 339 : first + 339 + len(cds) - 240] = cds[240:]
        else:
            exons = [(first, first + len(cds) - 1)]
            seq[first - 1 : first - 1 + len(cds)] = cds
        genes.append((first, exons[-1][1], "-" if i == 3 else "+", exons))
    base = "".join(seq)
    for g in range(n_genomes):
        chrom = f"chr{'ABC'[g]}1"
        text = base if g == 0 else _point_mutations(rng, base, 0.02)
        with open(os.path.join(d, f"{prefix}{g}.fa"), "w") as fh:
            fh.write(f">{chrom}\n{text}\n")
        lines = ["##gff-version 3"]
        for i, (first, last, strand, exons) in enumerate(genes):
            gid = f"{'ABC'[g]}g{i}"
            lines.append(f"{chrom}\tsim\tgene\t{first}\t{last}\t.\t{strand}\t.\tID={gid}")
            lines.append(f"{chrom}\tsim\tmRNA\t{first}\t{last}\t.\t{strand}\t.\t"
                         f"ID={gid}.t1;Parent={gid}")
            for a, b in exons:
                lines.append(f"{chrom}\tsim\tCDS\t{a}\t{b}\t.\t{strand}\t0\tParent={gid}.t1")
        with open(os.path.join(d, f"{prefix}{g}.gff3"), "w") as fh:
            fh.write("\n".join(lines) + "\n")


def _write_vcf(path, samples, sites, rng, gq=(5, 99)):
    """A VCF of biallelic SNVs at `sites` [(chrom, pos, ref, alt)] with one
    random genotype (0, 1 or 2 alternative copies; -1 missing) a sample."""
    from ngsepcore_tpu_torch.variants.model import TYPE_BIALLELIC_SNV, CalledGenomicVariant
    from ngsepcore_tpu_torch.vcf.io import VCFFileWriter, VCFRecord

    with VCFFileWriter(path, samples) as w:
        for chrom, pos, ref, alt, genos in sites:
            calls = [CalledGenomicVariant(
                sequence_name=chrom, first=pos, alleles=[ref, alt],
                variant_type=TYPE_BIALLELIC_SNV, quality=60, sample_id=s,
                indexes_called_alleles=[[], [0, 0], [0, 1], [1, 1]][g + 1],
                genotype_quality=int(rng.integers(*gq))) for s, g in zip(samples, genos)]
            w.write(VCFRecord(variant=calls[0], calls=calls))


def write_long_tail_inputs(d):
    """Phase 20's inputs (also tests/test_torch_cli.py's): a 43 kb genome
    with two transposon families (20 exact copies of 500 bp, 4 copies of
    800 bp at 3%) and their library; three 30 kb genomes with ten gene
    models each; three protein catalogs of 64 and two cDNA catalogs of 30;
    an individuals VCF and its
    TILLING pools; a TILLING population simulated on the genome (the
    genotyper's input); a gold-standard and a test VCF; a lane FASTQ of
    barcoded reads with adapters and its barcodes."""
    from ngsepcore_tpu_torch.core.genome import ReferenceGenome
    from ngsepcore_tpu_torch.simulation.tilling import TillingPopulationSimulator
    from ngsepcore_tpu_torch.vcf.io import VCFFileWriter

    rng = np.random.default_rng(20)
    te1, te2 = _random_dna(rng, 500), _random_dna(rng, 800)
    genome = _random_dna(rng, 3000)
    for i in range(20):
        genome += te1 + _random_dna(rng, 1500)
        if i % 5 == 0:
            genome += _point_mutations(rng, te2, 0.03) + _random_dna(rng, 1000)
    with open(os.path.join(d, "g.fa"), "w") as fh:
        fh.write(f">chr1\n{genome}\n")
    with open(os.path.join(d, "lib.fa"), "w") as fh:
        fh.write(f">TE1\n{te1}\n>TE2\n{te2}\n")
    _gene_genomes(d, rng)
    write_catalogs(d, protein_catalogs(rng, 40, 6, lengths=(120, 200)))
    # TILLING: 6 individuals in 2 x 3 pools, 20 SNVs
    inds = [f"ind{i}" for i in range(6)]
    with open(os.path.join(d, "pools.txt"), "w") as fh:
        fh.write("Individual;Pool1;Pool2\n")
        fh.writelines(f"{s};R{i // 3};C{i % 3}\n" for i, s in enumerate(inds))
    sites = []
    for pos in sorted(rng.choice(np.arange(100, 40_000), size=20, replace=False)):
        ref = genome[pos - 1]
        sites.append(("chr1", int(pos), ref, "ACGT"[("ACGT".index(ref) + 1) % 4],
                      [int(g) for g in rng.choice([0, 0, 0, 1, 2, -1], size=6)]))
    _write_vcf(os.path.join(d, "individuals.vcf"), inds, sites, rng)
    sim = TillingPopulationSimulator(ReferenceGenome.load(os.path.join(d, "g.fa")),
                                     n_individuals=24, seed=3)
    sim.build_design(n_cols=6)
    sim.simulate_mutations()
    with open(os.path.join(d, "sim_design.txt"), "w") as fh:
        for ind, pools in sim.design.pools_per_individual.items():
            fh.write(f"{ind}\t{','.join(sorted(pools))}\n")
    for pool, recs in sorted(sim.pool_variant_records().items()):
        with VCFFileWriter(os.path.join(d, f"sim_{pool}.vcf"), [pool]) as w:
            for r in recs:
                w.write(r)
    # gold standard against a test call set: changed genotypes, missed
    # and extra sites, positions off by one
    gold, test = [], []
    for pos in sorted(rng.choice(np.arange(100, 40_000), size=60, replace=False)):
        ref = genome[pos - 1]
        alt = "ACGT"[("ACGT".index(ref) + 2) % 4]
        g = int(rng.integers(1, 3))
        gold.append(("chr1", int(pos), ref, alt, [g]))
        r = rng.random()
        if r < 0.7:
            test.append(("chr1", int(pos), ref, alt, [g]))
        elif r < 0.8:
            test.append(("chr1", int(pos), ref, alt, [3 - g]))
        elif r < 0.9:
            test.append(("chr1", int(pos) + 1, ref, alt, [g]))
    test += [("chr1", int(p), "A", "C", [1]) for p in rng.choice(np.arange(40_001, 43_000), 8)]
    test.sort(key=lambda t: t[1])
    _write_vcf(os.path.join(d, "gold.vcf"), ["s"], gold, rng)
    _write_vcf(os.path.join(d, "test.vcf"), ["s"], test, rng)
    # demultiplexing: four barcodes (one a prefix of another), reads with
    # an adapter after their payload, some unbarcoded, some too short
    barcodes = {"ACGT": "s1", "ACGTTT": "s2", "GGGA": "3x", "TTAC": "s4"}
    with open(os.path.join(d, "barcodes.txt"), "w") as fh:
        fh.writelines(f"{b}\t{s}\n" for b, s in barcodes.items())
    with open(os.path.join(d, "lane.fastq"), "w") as fh:
        for i in range(400):
            bc = ["ACGT", "ACGTTT", "GGGA", "TTAC", "CCCC"][i % 5]
            payload = _random_dna(rng, int(rng.integers(10, 90)))
            seq = bc + payload + ("AGATCGGAAG" + _random_dna(rng, 12) if i % 3 == 0 else "")
            qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 41, size=len(seq)))
            fh.write(f"@r{i}\n{seq}\n+\n{qual}\n")
    # two cDNA catalogs of 30 transcripts (200-300 bp, 3% substitutions)
    cdna = [_random_dna(rng, int(rng.integers(200, 301))) for _ in range(30)]
    for c in range(2):
        with open(os.path.join(d, f"cdna{c}.fa"), "w") as fh:
            fh.writelines(f">t{i}\n{_point_mutations(rng, s, 0.03)}\n"
                          for i, s in enumerate(cdna))


def long_tail_jobs(d):
    """{label: CLI arguments} of the eight commands on write_long_tail_inputs'
    files, `{o}` the output prefix; TransposonsFinder runs in both modes,
    CDNACatalogAligner on protein and on cDNA catalogs."""
    import glob

    pools = sorted(glob.glob(os.path.join(d, "sim_*.vcf")))
    jobs = {
        "TillingIndividualVCF2PoolVCF": ["{d}/individuals.vcf", "{d}/pools.txt", "{o}.vcf"],
        "TillingPopulationSimulator": ["{d}/g.fa", "{o}", "-n", "24", "-s", "3"],
        "TillingPoolsIndividualGenotyper": ["-d", "{d}/sim_design.txt", "-o", "{o}.txt"] + pools,
        "VCFGoldStandardComparator": ["{d}/gold.vcf", "{d}/test.vcf", "-t", "1", "-o", "{o}.txt"],
        "Demultiplex": ["-b", "{d}/barcodes.txt", "-o", "{o}", "-u", "-a", "AGATCGGAAG",
                        "-m", "20", "{d}/lane.fastq"],
        "GenomesAligner": ["-o", "{o}"] + [f"{{d}}/ga{g}.{e}" for g in range(3)
                                           for e in ("fa", "gff3")],
        "CDNACatalogAligner": ["-o", "{o}", "{d}/cat0.fa", "{d}/cat1.fa", "{d}/cat2.fa"],
        "CDNACatalogAligner cdna": ["-o", "{o}", "{d}/cdna0.fa", "{d}/cdna1.fa"],
        "TransposonsFinder": ["{d}/g.fa", "-o", "{o}.gff"],
        "TransposonsFinder -d": ["{d}/g.fa", "-d", "{d}/lib.fa", "-o", "{o}.gff"],
    }
    return {label: [a.replace("{d}", d) for a in args] for label, args in jobs.items()}


def _revcomp(seq):
    return seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def write_gbs_fastq(path, rng, loci, snv_locus, snv_col, snv_alt, haps, depth, length=None,
                    error=0.003, quality=30, n_rate=0.0):
    """One diploid sample's FASTQ over GBS loci (each read from the cut site,
    so all reads of a locus share its prefix): `depth` reads a locus (an int
    or one a locus), each from one of the sample's two haplotypes at random;
    haps (2, SNVs) says which haplotype carries each SNV's alternative
    (snv_alt at column snv_col of locus snv_locus); substitution errors at
    `error`, N at `n_rate`, lengths drawn from `length` (lo, hi) or the
    whole locus, qualities one value or drawn from (lo, hi).  loci is
    (loci, L) codes."""
    n_loci, L = loci.shape
    hap_codes = np.stack([loci, loci])
    for h in (0, 1):
        hap_codes[h, snv_locus[haps[h]], snv_col[haps[h]]] = snv_alt[haps[h]]
    which = np.repeat(np.arange(n_loci), np.broadcast_to(depth, (n_loci,)))
    which = which[rng.permutation(len(which))]
    reads = hap_codes[rng.integers(0, 2, len(which)), which]
    err = rng.random(reads.shape)
    reads = np.where(err < error, (reads + rng.integers(1, 4, reads.shape)) % 4, reads)
    reads = np.where(err > 1 - n_rate, 4, reads)
    qual = (np.full(reads.shape, quality) if np.isscalar(quality)
            else rng.integers(quality[0], quality[1], reads.shape))
    seq = np.frombuffer(b"ACGTN", np.uint8)[reads]
    qual = (qual + 33).astype(np.uint8)
    lengths = (np.full(len(reads), L) if length is None
               else rng.integers(length[0], length[1], len(reads)))
    with open(path, "wb") as fh:
        if (lengths == L).all():  # fixed-width records in one write
            rec = np.empty((len(reads), 2 * L + 7), np.uint8)
            rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
            rec[:, 3 : 3 + L] = seq
            rec[:, 3 + L : 6 + L] = np.frombuffer(b"\n+\n", np.uint8)
            rec[:, 6 + L : 6 + 2 * L] = qual
            rec[:, -1] = ord("\n")
            fh.write(rec.tobytes())
        else:
            fh.writelines(b"@r\n" + a[:n].tobytes() + b"\n+\n" + b[:n].tobytes() + b"\n"
                          for a, b, n in zip(seq, qual, lengths))


def genotype_haps(rng, genotypes):
    """(2, SNVs) haplotype carriers of diploid genotypes 0, 1, 2 (a
    heterozygote's alternative on a haplotype at random)."""
    g = np.asarray(genotypes)
    first = rng.random(len(g)) < 0.5
    return np.stack([(g == 2) | ((g == 1) & first), (g == 2) | ((g == 1) & ~first)])


def write_transcriptome_gbs_inputs(d):
    """Phase 22's inputs (also tests/test_torch_cli.py's), about 45 kb in
    all: a 30 kb genome with ten gene models and two more transcripts (one
    with UTRs, one non-coding) and a VCF of SNVs and indels over it
    (VCFAnnotate, MutatedPeptidesExtractor, TranscriptomeAnalyzer,
    TranscriptomeFilter); four GBS samples' FASTQs over 80 loci of 100 bp
    (DeNovoGBS); a 12 kb genome, a de-novo cluster VCF and a SAM of its
    cluster consensus sequences on the genome, both strands, gapped,
    clipped, unmapped and missing (VCFRelativeCoordinatesTranslator); a
    UNEAK HapMap table and its tag pairs (UneakToVCFConverter)."""
    rng = np.random.default_rng(22)
    _gene_genomes(d, rng, n_genomes=1, prefix="tx")
    with open(os.path.join(d, "tx0.fa")) as fh:
        genome = fh.read().split("\n")[1]
    with open(os.path.join(d, "tx0.gff3")) as fh:
        gff = fh.read()
    gff += ("chrA1\tsim\tmRNA\t3751\t4306\t.\t+\t.\tID=Ag1.t2;Parent=Ag1\n"
            "chrA1\tsim\tfive_prime_UTR\t3751\t3800\t.\t+\t.\tParent=Ag1.t2\n"
            "chrA1\tsim\tCDS\t3801\t4256\t.\t+\t0\tParent=Ag1.t2\n"
            "chrA1\tsim\tthree_prime_UTR\t4257\t4306\t.\t+\t.\tParent=Ag1.t2\n"
            "chrA1\tsim\tgene\t28001\t28600\t.\t-\t.\tID=Anc\n"
            "chrA1\tsim\tmRNA\t28001\t28600\t.\t-\t.\tID=Anc.t1;Parent=Anc\n"
            "chrA1\tsim\texon\t28001\t28200\t.\t-\t.\tParent=Anc.t1\n"
            "chrA1\tsim\texon\t28401\t28600\t.\t-\t.\tParent=Anc.t1\n")
    with open(os.path.join(d, "genes.gff3"), "w") as fh:
        fh.write(gff)
    # SNVs at random, at the start codons and around gene 5's intron
    # (15,241-15,340), in the UTRs and the non-coding exons; indels of 1-3
    # bases in coding sequence
    pos = set(int(p) for p in rng.choice(np.arange(30, 29_970), size=300, replace=False))
    pos |= {1001 + 2800 * i for i in range(10)} | {15_240 + k for k in range(-1, 4)}
    pos |= {15_339 + k for k in range(-2, 3)} | {3760, 4300, 28_100, 28_300, 28_500}
    lines = []
    for p in sorted(pos):
        ref = genome[p - 1]
        alt = "ACGT"[("ACGT".index(ref) + int(rng.integers(1, 4))) % 4]
        lines.append((p, ref, alt))
    for p in rng.choice(np.arange(1100, 27_000, 2800), size=8, replace=False):
        k = int(rng.integers(1, 4))
        p = int(p) + int(rng.integers(0, 100))
        if rng.random() < 0.5:
            lines.append((p, genome[p - 1 : p + k], genome[p - 1]))
        else:
            lines.append((p, genome[p - 1], genome[p - 1] + _random_dna(rng, k)))
    with open(os.path.join(d, "annot.vcf"), "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
                 "\tFORMAT\ts1\ts2\n")
        for p, ref, alt in sorted(lines):
            g = ["0/1", "1/1", "0/0", "./."]
            fh.write(f"chrA1\t{p}\t.\t{ref}\t{alt}\t60\tPASS\t.\tGT\t"
                     f"{g[int(rng.integers(0, 4))]}\t{g[int(rng.integers(0, 4))]}\n")
    # GBS: 80 loci of 100 bp, 0-2 SNVs a locus past the prefix
    from ngsepcore_tpu_torch.core.sequences import encode_dna

    loci = np.stack([encode_dna(_random_dna(rng, 100)) for _ in range(80)])
    snv_locus = np.repeat(np.arange(80), rng.integers(0, 3, 80))
    snv_col = rng.integers(31, 100, len(snv_locus))
    snv_alt = (loci[snv_locus, snv_col] + 1) % 4
    for si in range(4):
        haps = genotype_haps(rng, rng.integers(0, 3, len(snv_locus)))
        write_gbs_fastq(os.path.join(d, f"gbs_s{si}.fastq"), rng, loci, snv_locus, snv_col,
                        snv_alt, haps, rng.poisson(10, size=80), length=(80, 101),
                        error=0.01, quality=(2, 41), n_rate=0.002)
    # the translator: 40 cluster consensus sequences of 90 bp from a 12 kb
    # genome, odd ones aligned on the minus strand; every seventh carries
    # the alternative allele as its reference
    ref_genome = _random_dna(rng, 12_000)
    with open(os.path.join(d, "gbs_genome.fa"), "w") as fh:
        fh.write(f">chrG\n{ref_genome}\n")
    sam = ["@HD\tVN:1.6", "@SQ\tSN:chrG\tLN:12000"]
    vcf = []
    for c in range(1, 41):
        start = 200 + 280 * c
        read = ref_genome[start - 1 : start - 1 + 90]  # the aligned orientation
        rev = c % 2 == 1
        cons = _revcomp(read) if rev else read
        cigar = ["90M", "40M2D50M", "30M2I58M", "5S85M"][c % 4]
        if c in (36, 37, 38):
            sam.append(f"Cluster_{c}\t4\t*\t0\t0\t*\t*\t0\t0\t{cons}\t*")
        elif c < 39:
            sam.append(f"Cluster_{c}\t{16 if rev else 0}\tchrG\t{start}\t60\t{cigar}\t*\t0\t0"
                       f"\t{read}\t*")
        for col in sorted(rng.choice(np.arange(32, 90), size=2, replace=False)):
            base = cons[col - 1]
            alt = "ACGT"[("ACGT".index(base) + 1) % 4]
            alleles = [base, alt] if c % 7 else [alt, base]
            if c == 12:
                alleles = [base, alt, "ACGT"[("ACGT".index(base) + 2) % 4]]
            if c == 13:
                alleles = [base + "A", base]
            vcf.append((c, int(col), alleles))
    with open(os.path.join(d, "clusters.vcf"), "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
                 "\tFORMAT\tg1\tg2\tg3\n")
        for c, col, alleles in vcf:
            g = ["0/0", "0/1", "1/1", "./."]
            if len(alleles) == 3:
                g = ["1/2", "0/2", "2/2", "0/1"]
            calls = "\t".join(f"{g[int(rng.integers(0, 4))]}:{int(rng.integers(5, 99))}"
                              f":{int(rng.integers(1, 40))}" for _ in range(3))
            fh.write(f"Cluster_{c}\t{col}\t.\t{alleles[0]}\t{','.join(alleles[1:])}\t50"
                     f"\tPASS\t.\tGT:GQ:DP\t{calls}\n")
    with open(os.path.join(d, "consensus.sam"), "w") as fh:
        fh.write("\n".join(sam) + "\n")
    # UNEAK: 30 sites x 6 samples, tag pairs of 64 bp differing at one
    # offset (none for the last site)
    cols = ["rs#", "alleles", "chrom", "pos", "strand", "assembly#", "center", "protLSID",
            "assayLSID", "panelLSID", "QCcode"] + [f"S{i}" for i in range(6)]
    rows, tags = ["\t".join(cols)], []
    for i in range(30):
        t1 = _random_dna(rng, 64)
        off = int(rng.integers(0, 64))
        a1 = t1[off]
        a2 = "ACGT"[("ACGT".index(a1) + 1) % 4]
        t2 = t1[:off] + a2 + t1[off + 1 :] if i < 29 else t1
        het = {frozenset("AG"): "R", frozenset("CT"): "Y", frozenset("AC"): "M",
               frozenset("GT"): "K", frozenset("CG"): "S", frozenset("AT"): "W"}[
            frozenset(a1 + a2)]
        gts = [[a1, a2, het, "N"][int(rng.integers(0, 4))] for _ in range(6)]
        rows.append("\t".join([f"TP{i}", f"{a1}/{a2}", "0", str(i), "+"] + ["-"] * 6 + gts))
        tags += [f">TP{i}_q\n{t1}\n", f">TP{i}_h\n{t2}\n"]
    with open(os.path.join(d, "hapmap.txt"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    with open(os.path.join(d, "tags.fa"), "w") as fh:
        fh.writelines(tags)


def transcriptome_gbs_jobs(d):
    """{id: CLI arguments} of the seven commands on
    write_transcriptome_gbs_inputs' files, `{o}` the output prefix (what
    a command prints on its standard output is an output too)."""
    jobs = {
        "VCFAnnotate": ["-r", "{d}/tx0.fa", "-t", "{d}/genes.gff3", "-i", "{d}/annot.vcf",
                        "-o", "{o}.vcf"],
        "TranscriptomeAnalyzer": ["{d}/genes.gff3"],
        "TranscriptomeFilter": ["{d}/genes.gff3", "{o}.gff3", "-c", "-l", "300"],
        "MutatedPeptidesExtractor": ["{d}/tx0.fa", "{d}/genes.gff3", "{d}/annot.vcf",
                                     "-o", "{o}.txt"],
        "DeNovoGBS": ["-o", "{o}"] + [f"{{d}}/gbs_s{i}.fastq" for i in range(4)],
        "VCFRelativeCoordinatesTranslator": ["-r", "{d}/gbs_genome.fa", "{d}/clusters.vcf",
                                             "{d}/consensus.sam", "{o}"],
        "UneakToVCFConverter": ["{d}/hapmap.txt", "{d}/tags.fa", "{o}"],
    }
    return {cid: [a.replace("{d}", d) for a in args] for cid, args in jobs.items()}


def _dir_bytes(path):
    return {name: open(os.path.join(path, name), "rb").read() for name in sorted(os.listdir(path))}


def block_matrix(n, n_blocks, seed):
    """A random block similarity matrix (float32, symmetric, zero diagonal):
    weights 5-50 inside blocks, 1% of the pairs between blocks at 0-5."""
    rng = np.random.default_rng(seed)
    block = rng.integers(0, n_blocks, size=n)
    inside = block[:, None] == block[None, :]
    sim = np.where(inside, rng.uniform(5, 50, (n, n)),
                   np.where(rng.random((n, n)) < 0.01, rng.uniform(0, 5, (n, n)), 0))
    sim = np.triu(sim, 1).astype(np.float32)
    return sim + sim.T


def phase_long_tail_small(device="cuda"):
    """Phase 20, CUDA against the CPU: the eight commands of ROADMAP items
    17c-17e through the CLI on write_long_tail_inputs' files (all side by
    side, --profile on the card), every output file byte-equal; then
    mcl_cluster on a 2,000-node block matrix, clusters identical."""
    import torch

    from ngsepcore_tpu_torch.graphs.mcl import mcl_cluster, mcl_matrix

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        write_long_tail_inputs(d)
        jobs = long_tail_jobs(d)
        dirs, errs = _run_cli_jobs(jobs, d, device, "phase 20")
        calls = {}
        for label in jobs:
            files = _same_files(label, dirs[label, "dev"], dirs[label, "ref"], device,
                                "phase 20")
            m = re.search(r"device calls: mcl_cluster=(\d+) \(iterations (\d+)\) "
                          r"te_extractions=(\d+)", errs[label, "dev"])
            calls[label] = (tuple(int(x) for x in m.groups()), len(files))
        if calls["CDNACatalogAligner"][0][0] == 0 or calls["GenomesAligner"][0][0] == 0:
            fail(f"phase 20: no mcl_cluster call on the card: {calls}")
        if calls["TransposonsFinder -d"][0][2] != 2:
            fail(f"phase 20: the library search made {calls['TransposonsFinder -d'][0][2]} "
                 "extractions for 2 library sequences")
    cli_s = time.perf_counter() - t0
    sim = block_matrix(2000, 100, seed=20)
    got = {}
    for dev in (device, "cpu"):
        t1 = time.perf_counter()
        M, iters = mcl_matrix(sim, device=dev)
        clusters = mcl_cluster(sim, device=dev)
        got[dev] = (M, iters, clusters, time.perf_counter() - t1)
    if got[device][2] != got["cpu"][2]:
        fail("phase 20: mcl_cluster's clusters differ between the card and the CPU")
    err = float(np.abs(got[device][0] - got["cpu"][0]).max())
    log(f"phase 20 long tail small: {len(calls)} CLI runs x 2 devices byte-equal in {cli_s:.1f}s; "
        f"card mcl calls/iterations/te extractions, files: {calls}; "
        f"mcl 2000 nodes: {len(got['cpu'][2])} clusters equal, iterations "
        f"{device} {got[device][1]} cpu {got['cpu'][1]}, max |dM| {err:.3g}, "
        f"{got[device][3]:.2f}s / {got['cpu'][3]:.2f}s")
    torch.cuda.synchronize()


def repeat_truth(L, families):
    """Mask of the family source and copy intervals (0-based)."""
    truth = np.zeros(L, bool)
    for src, slen, _seg, copies in families:
        truth[src : src + slen] = True
        for dst in copies:
            truth[dst : dst + slen] = True
    return truth


def repeat_scores(anns, truth):
    """(covered share of the truth, precision) of annotations (1-based)."""
    pred = np.zeros(len(truth), bool)
    for a in anns:
        pred[a.first - 1 : a.last] = True
    both = int((pred & truth).sum())
    return both / int(truth.sum()), both / max(1, int(pred.sum()))


def _stage_split(profiling, prefix):
    return {k: round(v[0], 3) for k, v in profiling._stages.items() if k.startswith(prefix)}


def phase_long_tail_real_size(device="cuda"):
    """Phase 21, on the card at user size: TransposonsFinder's two modes on
    bench.build_repeat_genome(rng 2024, 12 Mbp) with the 30 family source
    segments as the library (GFF equal to the CPU's, coverage and precision
    gates over the families' source and copy intervals), then
    CDNACatalogAligner on three catalogs of 2,000 proteins (orthogroups
    equal to the CPU's, an exact-triple gate); stage seconds, call counts
    and peak device memory.  The GFF bodies without their source column
    and the orthogroup lines are held to the JAX package's CPU digests
    PHASE21_GFF_LIBRARY, PHASE21_GFF_DENOVO and PHASE21_ORTHOGROUPS (its
    calculate_orthogroups on the catalogs' text)."""
    import torch

    from ngsepcore_tpu_torch.__main__ import main as port_main
    from ngsepcore_tpu_torch.core.genome import ReferenceGenome
    from ngsepcore_tpu_torch.core.sequences import QualifiedSequence, QualifiedSequenceList
    from ngsepcore_tpu_torch.genome.transposons import (
        find_repeats_by_library,
        find_repeats_denovo,
        write_transposons_gff,
    )
    from ngsepcore_tpu_torch.graphs.mcl import mcl_cluster
    from ngsepcore_tpu_torch.utils import profiling

    codes, _, _, families = build_repeat_genome(np.random.default_rng(2024), 12_000_000, 30, 400)
    if not np.array_equal(codes, _bench_genome_codes()):
        fail("phase 21: the repeat genome differs from bench.build_repeat_genome's")
    seqs = QualifiedSequenceList()
    seqs.add(QualifiedSequence(name="chr1", codes=codes))
    genome = ReferenceGenome(seqs)
    library = [QualifiedSequence(name=f"family{i}", codes=f[2]) for i, f in enumerate(families)]
    truth = repeat_truth(len(codes), families)
    gates = {"library": (0.98, 0.99), "denovo": (0.0, 0.95)}
    report = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        for mode in ("library", "denovo"):
            gff = {}
            for dev in (device, "cpu"):
                profiling.enable()
                profiling.reset()
                torch.cuda.reset_peak_memory_stats()
                n0 = find_repeats_by_library.extractions
                t0 = time.perf_counter()
                anns = (find_repeats_by_library(genome, library, device=dev) if mode == "library"
                        else find_repeats_denovo(genome, device=dev))
                if dev == device:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                profiling.enable(False)
                gff[dev] = os.path.join(d, f"{mode}_{dev}.gff")
                write_transposons_gff(anns, gff[dev])
                if dev == device:
                    cov, prec = repeat_scores(anns, truth)
                    report[mode] = dict(
                        regions=len(anns), covered=round(cov, 4), precision=round(prec, 4),
                        s=round(wall, 3), stages_s=_stage_split(profiling, "te."),
                        extractions=find_repeats_by_library.extractions - n0,
                        peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
                else:
                    report[mode]["cpu_s"] = round(wall, 3)
            if open(gff[device], "rb").read() != open(gff["cpu"], "rb").read():
                fail(f"phase 21: TransposonsFinder {mode} GFF differs between {device} and cpu")
            report[mode]["digest"] = lines_digest(gff_body(gff[device]))
            need_cov, need_prec = gates[mode]
            if report[mode]["covered"] < need_cov or report[mode]["precision"] < need_prec:
                fail(f"phase 21: TransposonsFinder {mode} {report[mode]} misses its gates "
                     f"(covered >= {need_cov}, precision >= {need_prec})")
        paths = write_catalogs(d, protein_catalogs(np.random.default_rng(5), 1600, 100))
        og = {}
        for dev in (device, "cpu"):
            profiling.reset()
            torch.cuda.reset_peak_memory_stats()
            c0, i0 = mcl_cluster.calls, mcl_cluster.iterations
            out = os.path.join(d, f"catalogs_{dev}")
            t0 = time.perf_counter()
            with open(os.devnull, "w") as null:
                stderr, sys.stderr = sys.stderr, null
                try:  # --profile enables the stages and prints them to stderr
                    port_main(["--device", dev, "--profile", "CDNACatalogAligner", "-o", out]
                              + paths)
                finally:
                    sys.stderr = stderr
            wall = time.perf_counter() - t0
            profiling.enable(False)
            og[dev] = out + "_orthogroups.txt"
            if dev == device:
                with open(og[dev]) as fh:
                    sizes = [len(line.split("\t")) - 1 for line in fh]
                report["catalogs"] = dict(
                    groups=len(sizes), largest=max(sizes), exact_triples=exact_triples(og[dev]),
                    s=round(wall, 3), stages_s=_stage_split(profiling, "orthogroups."),
                    mcl_calls=mcl_cluster.calls - c0, mcl_iterations=mcl_cluster.iterations - i0,
                    peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
            else:
                report["catalogs"]["cpu_s"] = round(wall, 3)
                report["catalogs"]["cpu_stages_s"] = _stage_split(profiling, "orthogroups.")
        if open(og[device], "rb").read() != open(og["cpu"], "rb").read():
            fail("phase 21: CDNACatalogAligner orthogroups differ between the card and the CPU")
        report["catalogs"]["digest"] = lines_digest(file_lines(og[device]))
        if report["catalogs"]["exact_triples"] < 1400:
            fail(f"phase 21: {report['catalogs']['exact_triples']} of 1,600 orthologs as exact "
                 "triples (gate 1,400)")
    log(f"phase 21 long tail real size: {json.dumps(report)}")
    for key, want in (("library", PHASE21_GFF_LIBRARY), ("denovo", PHASE21_GFF_DENOVO),
                      ("catalogs", PHASE21_ORTHOGROUPS)):
        if report[key]["digest"] != want:
            fail(f"phase 21: the {key} digest {report[key]['digest']} is not the JAX "
                 f"package's {want}")
    return report


def _run_cli_jobs(jobs, d, device, where, timeout=600):
    """Each {label: args} job through the CLI on `device` and on the CPU,
    all side by side (--profile on the card), standard output to a file
    of the job's output directory; fails on a nonzero exit.  Returns
    ({(label, tag): output directory}, {(label, tag): standard error})."""
    procs = {}
    try:
        for label, args in jobs.items():
            cid = label.split()[0]
            for dev, tag in ((device, "dev"), ("cpu", "ref")):
                out = os.path.join(d, label.replace(" ", "_"), tag)
                os.makedirs(out)
                cmd = [sys.executable, "-m", "ngsepcore_tpu_torch", "--device", dev,
                       "--profile", cid] + [a.replace("{o}", out + "/out") for a in args]
                stdout = open(os.path.join(out, "standard_output"), "w")
                procs[label, tag] = (out, stdout, subprocess.Popen(
                    cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                    stdout=stdout, stderr=subprocess.PIPE, text=True))
        errs = {}
        for key, (_, stdout, proc) in procs.items():
            _, errs[key] = proc.communicate(timeout=timeout)
            stdout.close()
            if proc.returncode != 0:
                print(errs[key][-4000:], flush=True)
                fail(f"{where}: {key[0]} on {key[1]} exited {proc.returncode}")
    finally:
        for _, stdout, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            stdout.close()
    return {key: v[0] for key, v in procs.items()}, errs


def _same_files(label, dev_dir, ref_dir, device, where):
    """Fail unless the two output directories hold the same files with the
    same bytes (printing the first differing lines), every file but the
    standard output not empty, one at least; returns the files."""
    dev_files, ref_files = _dir_bytes(dev_dir), _dir_bytes(ref_dir)
    written = [v for k, v in dev_files.items() if k != "standard_output"]
    if dev_files != ref_files or not any(dev_files.values()) or not all(written):
        import difflib

        for name in sorted(set(dev_files) & set(ref_files)):
            if dev_files[name] != ref_files[name]:
                print("".join(list(difflib.unified_diff(
                    ref_files[name].decode(errors="replace").splitlines(True),
                    dev_files[name].decode(errors="replace").splitlines(True),
                    f"cpu/{name}", f"{device}/{name}", n=0))[:40]), flush=True)
        fail(f"{where}: {label} output differs between {device} and cpu "
             f"({sorted(dev_files)} / {sorted(ref_files)})")
    return dev_files


def _mutated_family(rng, n, length, rate=0.03, indel=0.01):
    """n copies of a random source of `length` bp, each with substitutions
    at `rate` and single-base indels at `indel`."""
    src = _random_dna(rng, length)
    out = []
    for _ in range(n):
        s = list(_point_mutations(rng, src, rate))
        for p in sorted(rng.choice(len(s), size=int(indel * len(s)), replace=False))[::-1]:
            if rng.random() < 0.5:
                del s[p]
            else:
                s.insert(p, "ACGT"[int(rng.integers(0, 4))])
        out.append("".join(s))
    return out


def _pairs_batch(rng, B, lo, hi):
    """B pairs of related sequences of lo-hi bp (the second a mutated copy
    of the first), packed as code matrices with N padding."""
    from ngsepcore_tpu_torch.core.sequences import encode_dna, pack_reads

    a = [_random_dna(rng, int(rng.integers(lo, hi + 1))) for _ in range(B)]
    b = [_point_mutations(rng, x, 0.05) for x in a]
    b = [x[: len(x) - int(rng.integers(0, 20))] for x in b]
    q, ql, _ = pack_reads([encode_dna(x) for x in a], pad_multiple=32)
    s, sl, _ = pack_reads([encode_dna(x) for x in b], pad_multiple=32)
    return q, ql, s, sl


def genotype_records(var, vcf, dosages, samples, first=100, step=100):
    """Biallelic SNV records (of the package whose variants and VCF modules
    are `var` and `vcf`) of (sites, samples) dosages 0-2, -1 missing (an
    undecided call).  The calls are objects shared by sample and genotype:
    an association reads only their genotypes."""
    calls = {(s, g): var.CalledGenomicVariant(
        sequence_name="chr1", first=first, alleles=["A", "C"], sample_id=s,
        indexes_called_alleles=[[], [0, 0], [0, 1], [1, 1]][g + 1])
        for s in samples for g in (-1, 0, 1, 2)}
    return [vcf.VCFRecord(variant=var.CalledGenomicVariant(
        sequence_name="chr1", first=first + step * k, alleles=["A", "C"]),
        calls=[calls[s, int(g)] for s, g in zip(samples, row)])
        for k, row in enumerate(dosages)]


def phase_gbs_small(device="cuda"):
    """Phase 22, CUDA against the CPU: the seven commands of ROADMAP items
    17f and 17g through the CLI on write_transcriptome_gbs_inputs' files
    (side by side, --profile on the card), every output file and standard
    output byte-equal; in process, MSA of 40 sequences (rows equal, the
    Gotoh kernel launched), simple_gap_align_batch global and local and
    banded_align_batch on 1,024 pairs of 200-300 bp, dp_stats_pack on a
    tier-3 chunk (every output equal), GLM on 300 samples x 5,000 SNVs
    (tests/test_torch_long_tail.py's tolerances) and DBSCAN."""
    import torch

    from ngsepcore_tpu_torch.clustering.dbscan import DBSCANClusteringAlgorithm
    from ngsepcore_tpu_torch.clustering.msa import BestStarMultipleSequenceAlignmentAlgorithm
    from ngsepcore_tpu_torch.gwas.glm import GeneralLinearModel
    from ngsepcore_tpu_torch.kernels.pairwise import affine_gap_align_batch, dp_stats_pack
    from ngsepcore_tpu_torch.kernels.pairwise_cuda import gotoh_forward_plane
    from ngsepcore_tpu_torch.kernels.pairwise_simple import (
        banded_align_batch,
        simple_gap_align_batch,
    )

    report = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        write_transcriptome_gbs_inputs(d)
        jobs = transcriptome_gbs_jobs(d)
        dirs, errs = _run_cli_jobs(jobs, d, device, "phase 22")
        files = {label: _same_files(label, dirs[label, "dev"], dirs[label, "ref"], device,
                                    "phase 22")
                 for label in jobs}
        n_gbs = files["DeNovoGBS"]["out.vcf"].count(b"\nCluster_")
        if n_gbs < 20:
            fail(f"phase 22: DeNovoGBS called {n_gbs} variants on 80 loci")
    report["cli_s"] = round(time.perf_counter() - t0, 3)
    report["denovo_records"] = n_gbs
    rng = np.random.default_rng(22)
    # MSA of 40 sequences
    seqs = _mutated_family(rng, 40, 300)
    got = {}
    for dev in (device, "cpu"):
        n0 = gotoh_forward_plane.launches
        t1 = time.perf_counter()
        got[dev] = BestStarMultipleSequenceAlignmentAlgorithm(device=dev) \
            .calculate_multiple_sequence_alignment(seqs)
        report[f"msa_{dev}_s"] = round(time.perf_counter() - t1, 3)
        report[f"msa_{dev}_gotoh_launches"] = gotoh_forward_plane.launches - n0
    if got[device] != got["cpu"] or report[f"msa_{device}_gotoh_launches"] < 2:
        fail(f"phase 22: MSA rows differ between {device} and cpu, or the Gotoh kernel "
             f"did not run ({report})")
    if [a.replace("-", "") for a in got[device]] != seqs or len({len(a) for a in got[device]}) != 1:
        fail("phase 22: the MSA's rows are not its inputs with gaps, of one width")
    # the simple-gap and banded DPs on 1,024 pairs
    q, ql, s, sl = _pairs_batch(rng, 1024, 200, 300)
    cases = {
        "simple global": lambda *a: simple_gap_align_batch(*a),
        "simple local": lambda *a: simple_gap_align_batch(
            *a, local=True, force_start1=False, force_start2=False, force_end1=False,
            force_end2=False),
        "banded k 24": lambda *a: banded_align_batch(*a, k=24),
    }
    for name, fn in cases.items():
        out = {}
        for dev in (device, "cpu"):
            args = [torch.from_numpy(x).to(dev) for x in (q, ql, s, sl)]
            t1 = time.perf_counter()
            out[dev] = {k: v.cpu() for k, v in fn(*args).items()}
            report[f"{name} {dev}_s"] = round(time.perf_counter() - t1, 3)
        bad = {k: int((out[device][k] != out["cpu"][k]).sum()) for k in out["cpu"]}
        if any(bad.values()):
            fail(f"phase 22: {name} differs between {device} and cpu: {bad}")
    # dp_stats_pack on a tier-3 chunk
    q, ql, s, sl = _bench_chunk(rng, 2048, 160, 160)
    out = {}
    for dev in (device, "cpu"):
        args = [torch.from_numpy(x).to(dev) for x in (q, ql, s, sl)]
        aln = affine_gap_align_batch(*args, free_start2=True, free_end2=True)
        out[dev] = {k: v.cpu() for k, v in dp_stats_pack(
            aln["ops"], aln["n_ops"], aln["start_j"], aln["score"], args[0], args[2]).items()}
    bad = {k: int((out[device][k] != out["cpu"][k]).sum()) for k in out["cpu"]}
    if any(bad.values()):
        fail(f"phase 22: dp_stats_pack differs between {device} and cpu: {bad}")
    report["dp_stats_pack_gapped_rows"] = int(out["cpu"]["has_gap"].sum())
    # GLM on 300 samples x 5,000 SNVs
    import ngsepcore_tpu_torch.variants.model as var
    import ngsepcore_tpu_torch.vcf.io as vcf

    samples = [f"s{i}" for i in range(300)]
    dos = rng.integers(0, 3, (5000, 300))
    dos[rng.random(dos.shape) < 0.1] = -1
    recs = genotype_records(var, vcf, dos, samples)
    y = dos[:10].clip(0).sum(axis=0) * 0.5 + rng.normal(0, 1, 300)
    pheno = {s: float(y[i]) for i, s in enumerate(samples)}
    res = {}
    for dev in (device, "cpu"):
        t1 = time.perf_counter()
        res[dev] = GeneralLinearModel(device=dev).run_association(recs, pheno)
        report[f"glm_{dev}_s"] = round(time.perf_counter() - t1, 3)
    a, b = res[device], res["cpu"]
    same_sites = [(r["position"], r["n"]) for r in a] == [(r["position"], r["n"]) for r in b]
    err = {k: float(max(abs(x[k] - y[k]) for x, y in zip(a, b))) for k in ("beta", "r2", "p")}
    err["beta_rel"] = float(max(abs(x["beta"] - y["beta"]) / max(abs(y["beta"]), 1e-300)
                                for x, y in zip(a, b)))
    f_ok = all(abs(x["f"] - y["f"]) <= 1e-12 * (y["n"] - 2) for x, y in zip(a, b))
    if (not same_sites or err["beta_rel"] > 1e-10 or err["r2"] > 1e-12 or err["p"] > 1e-8
            or not f_ok or len(a) < 4900):
        fail(f"phase 22: GLM on {device} outside the tolerance of the CPU's: {len(a)} / "
             f"{len(b)} sites, {err}")
    report["glm_sites"], report["glm_err"] = len(a), err
    # DBSCAN over a 2,000-point neighbourhood graph of 20 planted groups
    pts = np.concatenate([rng.normal(c, 0.02, (100, 2)) for c in rng.random((20, 2)) * 10])
    dist = np.linalg.norm(pts[:, None] - pts[None, :], axis=2)
    adjacency = [list(np.flatnonzero((row < 0.1) & (np.arange(len(pts)) != i)))
                 for i, row in enumerate(dist)]
    clusters = DBSCANClusteringAlgorithm().run_dbscan_clustering(
        list(range(len(pts))), adjacency, 4)
    report["dbscan_clusters"] = len(clusters)
    if len(clusters) < 15:
        fail(f"phase 22: DBSCAN found {len(clusters)} of 20 planted groups")
    report["s"] = round(time.perf_counter() - t0, 3)
    log(f"phase 22 gbs/transcriptome small: {len(jobs)} CLI runs x 2 devices byte-equal; "
        f"{json.dumps(report)}")
    torch.cuda.synchronize()


GBS_SAMPLES = 24
GBS_LOCI = 10_000
GBS_READ_LEN = 100
APEKI = ("GCAGC", "GCTGC")  # G^CWGC


def apeki_loci(codes, merged, n_loci, read_len=GBS_READ_LEN, spacing=200):
    """Start offsets (0-based) of the first n_loci ApeKI loci on the forward
    strand: the read_len bases from each cut site (after the motif's G)
    outside every merged repeat interval, each at least `spacing` bp after
    the last one taken."""
    L = len(codes)
    hit = np.zeros(L, bool)
    for motif in APEKI:
        m = np.frombuffer(motif.encode(), np.uint8)
        m = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), m)
        ok = np.ones(L - len(m) + 1, bool)
        for k, c in enumerate(m):
            ok &= codes[k : L - len(m) + 1 + k] == c
        hit[: len(ok)] |= ok
    starts = np.flatnonzero(hit) + 1
    starts = starts[starts + read_len <= L]
    rep = np.zeros(L + 1, np.int64)
    for lo, hi in merged:
        rep[lo] += 1
        rep[hi] -= 1
    covered = np.concatenate([[0], np.cumsum(np.cumsum(rep)[:-1] > 0)])
    starts = starts[covered[starts + read_len] == covered[starts]]
    out, last = [], -spacing
    for p in starts:
        if p - last >= spacing:
            out.append(int(p))
            last = p
            if len(out) == n_loci:
                break
    return np.array(out, np.int64)


def gbs_population(rng, codes, starts, n_samples, read_len=GBS_READ_LEN, snv_every=100):
    """Planted SNVs at 1 per `snv_every` bp at locus columns 31-99 (1-based
    positions 32-100), alt frequency uniform in [0.05, 0.5], diploid
    genotypes in Hardy-Weinberg proportions.  Returns (loci (n, read_len)
    int8, SNV locus, SNV column, SNV alt code, haplotypes (samples, 2,
    SNVs) bool)."""
    loci = codes[starts[:, None] + np.arange(read_len)[None, :]]
    cols = np.arange(31, read_len)
    at = rng.random((len(starts), len(cols))) < 1 / snv_every
    s_locus, s_col = np.nonzero(at)
    s_col = cols[s_col]
    s_alt = ((loci[s_locus, s_col] + rng.integers(1, 4, len(s_locus))) % 4).astype(np.int8)
    freq = rng.uniform(0.05, 0.5, len(s_locus))
    haps = rng.random((n_samples, 2, len(s_locus))) < freq[None, None, :]
    return loci, s_locus, s_col, s_alt, haps


GBS_BP = 12_000_000  # bench.build_repeat_genome's


def gbs_inputs(d, bp=GBS_BP, n_loci=GBS_LOCI, n_samples=GBS_SAMPLES):
    """Phase 23's lane, written to directory d: the first n_loci ApeKI loci
    of build_repeat_genome(rng 2024, bp) with bench's 30 families and 400
    tandem arrays scaled by bp / 12 Mbp, gbs_population's planted SNVs and
    one FASTQ a sample (Poisson(8) reads a locus, 0.3% errors, Q30), all
    drawn from rng 23.  Returns the FASTQ paths, the sample ids and what
    the gates read: loci, s_locus, s_col, s_alt, haps."""
    rng = np.random.default_rng(23)
    scale = bp / GBS_BP
    codes, merged, _, _ = build_repeat_genome(np.random.default_rng(2024), bp,
                                              round(30 * scale), round(400 * scale))
    starts = apeki_loci(codes, merged, n_loci)
    if len(starts) < n_loci:
        fail(f"phase 23: {len(starts)} ApeKI loci outside the repeats, not {n_loci}")
    loci, s_locus, s_col, s_alt, haps = gbs_population(rng, codes, starts, n_samples)
    paths = [os.path.join(d, f"gbs{si:02d}.fastq") for si in range(n_samples)]
    for si, path in enumerate(paths):
        write_gbs_fastq(path, rng, loci, s_locus, s_col, s_alt, haps[si],
                        rng.poisson(8, len(loci)))
    return dict(paths=paths, ids=[f"gbs{i:02d}" for i in range(n_samples)], loci=loci, s_locus=s_locus, s_col=s_col, s_alt=s_alt, haps=haps)


def _vcf_records_text(path):
    """{cluster id: [record lines]} of a de-novo GBS VCF."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("Cluster_"):
                out.setdefault(int(line[8 : line.index("\t")]), []).append(line)
    return out


def _timed_once(fn):
    """(ms, result) of one fn() between two CUDA events."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def _msa_shape_entry(name, pairs, device):
    """Timing of the Gotoh kernel and of the walk (runs mode, budget Lq +
    Ls) on one of the MSA's batches (a list of code pairs, packed as the
    MSA packs them), beside their plain versions and bounds."""
    import torch

    from ngsepcore_tpu_torch.core.sequences import pack_reads
    from ngsepcore_tpu_torch.kernels import pairwise
    from ngsepcore_tpu_torch.kernels.pairwise_cuda import (
        gotoh_forward_plane,
        gotoh_forward_plane_ref,
        kernel_for,
    )

    L = max(max(len(a), len(b)) for a, b in pairs)
    q, ql, _ = pack_reads([a for a, _ in pairs], pad_to=L, pad_multiple=32)
    s, sl, _ = pack_reads([b for _, b in pairs], pad_to=L, pad_multiple=32)
    args = [torch.from_numpy(x).to(device) for x in (q, ql, s, sl)]
    cfg = dict(match=1, mismatch=1, open_gap=1, ext_gap=1)
    B, Lq, Ls = q.shape[0], q.shape[1], s.shape[1]
    got = gotoh_forward_plane(*args, **cfg)
    # the plain version's one run (seconds at these widths) is both the
    # reference and its time
    plain, ref = _timed_once(lambda: gotoh_forward_plane_ref(*args, **cfg))
    full, vec_bad, err = _gotoh_mismatches(got, ref)
    if full or any(vec_bad):
        fail(f"phase 23: the Gotoh kernel disagrees with its plain version on {name}")
    del ref
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: gotoh_forward_plane(*args, **cfg), reps=3, calls=3)
    g_ms = graph_ms(lambda: gotoh_forward_plane(*args, **cfg), calls=2, reps=3)
    torch.cuda.empty_cache()
    b_ms, b_by = gotoh_bound(B, Lq, Ls)
    gotoh_t = dict(ms=ms, plain_ms=plain, max_abs_err=err, graph_ms=g_ms, bound_ms=b_ms,
                   bound_by=b_by, shape=f"{B}x{Lq}x{Ls}", kernel=kernel_for(Ls))
    plane, score, end_i, end_j, start_k = got
    R = Lq + Ls
    wargs = (plane, score, end_i, end_j, start_k, B, R, True)
    runs = pairwise._runs_from_plane(*wargs)
    w_plain, want = _timed_once(lambda: pairwise._runs_from_plane_ref(*wargs))
    bad = {k: int((runs[k] != want[k]).sum()) for k in want}
    if any(bad.values()):
        fail(f"phase 23: the walk disagrees with its plain version on {name}: {bad}")
    w_ms = cuda_ms(lambda: pairwise._runs_from_plane(*wargs), reps=3, calls=5)
    w_g = graph_ms(lambda: pairwise._runs_from_plane(*wargs), calls=5, reps=3)
    loads = walk_loads(plane, end_i, end_j, start_k, R)
    wb_ms, wb_by = walk_bound(B, R, loads, "runs")
    walk_t = dict(ms=w_ms, plain_ms=w_plain, max_abs_err=0, graph_ms=w_g, bound_ms=wb_ms,
                  bound_by=wb_by, shape=f"{B}x{Lq}x{Ls} R {R}", mode="runs")
    log(f"  time MSA {name} {B}x{Lq}x{Ls} ({kernel_for(Ls)}): kernel {ms:.4f} ms (median of 3 "
        f"x 3 calls), {g_ms:.4f} ms in a CUDA graph of 2 calls, plain {plain:.3f} ms (one "
        f"call); bound "
        f"{b_ms:.4f} ms by {b_by}, kernel at {100 * b_ms / ms:.1f}% of it; walk R {R}: "
        f"{w_ms:.4f} ms, graph {w_g:.4f}, plain {w_plain:.3f}, bound {wb_ms:.4f} by {wb_by} "
        f"(longest chain {int(loads.max())} loads)")
    del plane, got, runs, want
    torch.cuda.empty_cache()
    return gotoh_t, walk_t


def _msa_cpu(families):
    """Phase 23's CPU side, in a process of its own: the best-star MSA of
    each family on the CPU with two torch threads; (rows of each, seconds)."""
    import torch

    from ngsepcore_tpu_torch.clustering.msa import BestStarMultipleSequenceAlignmentAlgorithm

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    rows = [BestStarMultipleSequenceAlignmentAlgorithm(device="cpu")
            .calculate_multiple_sequence_alignment(seqs) for seqs in families]
    return rows, time.perf_counter() - t0


def msa_families():
    """Phase 23's MSA input: the 30 repeat families of
    build_repeat_genome(rng 2024, 12 Mbp), each its source and copies as
    text; returns (families, their order by size, those whose widest
    sequence is over SEG_MAX_LS, the cluster kernel's, in that order)."""
    from ngsepcore_tpu_torch.core.sequences import decode_dna
    from ngsepcore_tpu_torch.kernels.pairwise_cuda import SEG_MAX_LS

    codes, _, _, families = build_repeat_genome(np.random.default_rng(2024), 12_000_000, 30,
                                                400)
    fams = [[decode_dna(codes[p : p + slen]) for p in [src] + list(copies)]
            for src, slen, _seg, copies in families]
    order = sorted(range(len(fams)), key=lambda i: (len(fams[i][0]), len(fams[i])))
    return fams, order, [i for i in order if max(map(len, fams[i])) > SEG_MAX_LS]


def start_msa_cpu():
    """Phase 23's CPU side, started now, each in a background process of its
    own: the MSA of the 5 smallest families and of the smallest family over
    SEG_MAX_LS (None where none is)."""
    fams, order, over_seg = msa_families()
    return (_InBackground(functools.partial(_msa_cpu, [fams[i] for i in order[:5]])),
            _InBackground(functools.partial(_msa_cpu, [fams[over_seg[0]]]))
            if over_seg else None)


def phase_gbs_real_size(device="cuda", msa_cpu=None):
    """Phase 23, on the card at user size: DeNovoGBS on a 24-plex ApeKI lane
    cut to 10,000 loci of bench.build_repeat_genome(rng 2024, 12 Mbp)
    (stage seconds, peak device memory; SNV precision and recall gates; the
    first 1,000 clusters' records equal to the port's CPU run on their
    reads; the VCF body's digest against the JAX package's, PHASE23_VCF),
    then the best-star MSA of each of the genome's 30 repeat families
    (source and copies: rows of one width that are their inputs with gaps,
    their digest against the JAX package's, PHASE23_MSA; CUDA rows equal
    to the CPU's for the 5 smallest families and the smallest family over
    SEG_MAX_LS, their CPU side in background processes: `msa_cpu`,
    start_msa_cpu()'s jobs started by an earlier phase, else started at
    the start of this one; Gotoh launches by kernel and shape, every
    family over SEG_MAX_LS on the cluster kernel; the batch with the most
    cells and the cluster kernel's timed against their plain version)."""
    import torch

    from ngsepcore_tpu_torch.clustering.msa import BestStarMultipleSequenceAlignmentAlgorithm
    from ngsepcore_tpu_torch.gbs.denovo import (
        GBSReads,
        KmerPrefixReadsClusteringAlgorithm,
        read_fastq_sample,
    )
    from ngsepcore_tpu_torch.kernels.pairwise import _runs_from_plane
    from ngsepcore_tpu_torch.kernels.pairwise_cuda import (
        SEG_MAX_LS,
        device_cluster_layout,
        gotoh_forward_plane,
    )
    from ngsepcore_tpu_torch.utils import profiling
    from ngsepcore_tpu_torch.vcf.io import VCFFileWriter

    # MSA of each repeat family: the source and its copies, read from the
    # genome; the CPU side of the comparison runs in the background
    fams, order, over_seg = msa_families()
    cpu_smallest, cpu_over_seg = msa_cpu or start_msa_cpu()
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        t0 = time.perf_counter()
        inp = gbs_inputs(d)
        paths, ids, loci = inp["paths"], inp["ids"], inp["loci"]
        s_locus, s_col, s_alt, haps = (inp[k] for k in ("s_locus", "s_col", "s_alt", "haps"))
        report = {"loci": len(loci), "planted_snvs": len(s_locus),
                  "setup_s": round(time.perf_counter() - t0, 3)}
        algo = KmerPrefixReadsClusteringAlgorithm(device=device)
        profiling.enable()
        profiling.reset()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        n_rec = algo.run(paths, ids, os.path.join(d, "lane"))
        torch.cuda.synchronize()
        report["run_s"] = round(time.perf_counter() - t1, 3)
        profiling.enable(False)
        report["stages_s"] = _stage_split(profiling, "gbs.")
        report["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
        report["host_bytes"] = algo.host_bytes
        report["records"] = n_rec
        # the clusters' prefix codes, for the gates and the CPU check
        reads = GBSReads.concatenate([read_fastq_sample(p, i) for i, p in enumerate(paths)])
        report["reads"] = len(reads.lengths)
        valid, code = algo.prefix_codes(reads)
        rows, cstarts = algo._cluster_layout(reads, GBS_SAMPLES)
        cluster_code = code[rows[cstarts]].cpu().numpy()
        report["clusters"] = len(cluster_code)
        w = 4 ** np.arange(30, -1, -1, dtype=np.int64)
        locus_of = {int(c): i for i, c in enumerate(loci[:, :31].astype(np.int64) @ w)}
        planted = {(int(l), int(c)): int(a) for l, c, a in zip(s_locus, s_col, s_alt)}
        carried = haps.any(axis=(0, 1))
        records = _vcf_records_text(os.path.join(d, "lane.vcf"))
        report["vcf_digest"] = vcf_body_digest(vcf_file_body(os.path.join(d, "lane.vcf")))
        true, found = 0, set()
        for cid, lines in records.items():
            li = locus_of.get(int(cluster_code[cid - 1]))
            for line in lines:
                f = line.split("\t")
                col, ref, alt = int(f[1]) - 1, f[3], f[4]
                key = (li, col)
                # the same two alleles: a record's REF is its cluster's
                # consensus, the planted alternative where most reads carry it
                ok = (li is not None and key in planted
                      and {ref, alt} == {"ACGT"[loci[li, col]], "ACGT"[planted[key]]})
                true += ok
                if ok:
                    found.add(key)
        want = {(int(l), int(c)) for l, c, k in zip(s_locus, s_col, carried) if k}
        report["precision"] = round(true / max(1, n_rec), 4)
        report["recall"] = round(len(found & want) / max(1, len(want)), 4)
        if report["precision"] < 0.90 or report["recall"] < 0.80:
            fail(f"phase 23: DeNovoGBS misses its gates (precision >= 0.90, recall >= 0.80): "
                 f"{report}")
        # the first 1,000 clusters on the CPU, from their reads
        last = int(cluster_code[min(1000, len(cluster_code)) - 1])
        c_all = code.cpu().numpy()
        keep = valid.cpu().numpy() & (c_all <= last)
        sub = GBSReads(reads.codes[keep], reads.quals[keep], reads.lengths[keep],
                       reads.samples[keep])
        t1 = time.perf_counter()
        cpu_recs = KmerPrefixReadsClusteringAlgorithm(device="cpu").call_variants(
            sub, GBS_SAMPLES)
        report["cpu_1000_s"] = round(time.perf_counter() - t1, 3)
        with VCFFileWriter(os.path.join(d, "cpu.vcf"), ids) as wr:
            for r in cpu_recs:
                wr.write(r)
        cpu_lines = _vcf_records_text(os.path.join(d, "cpu.vcf"))
        dev_lines = {cid: v for cid, v in records.items() if cid <= 1000}
        if cpu_lines != dev_lines or not cpu_lines:
            fail(f"phase 23: the records of the first 1,000 clusters differ between {device} "
                 f"and cpu ({sum(map(len, dev_lines.values()))} / "
                 f"{sum(map(len, cpu_lines.values()))} records)")
        report["first_1000_records"] = sum(map(len, cpu_lines.values()))
        del reads, sub, valid, code, rows, cstarts
    torch.cuda.empty_cache()
    log(f"phase 23 de-novo GBS real size: {json.dumps(report)}")
    if tuple(report["vcf_digest"]) != PHASE23_VCF:
        fail(f"phase 23: the VCF body {report['vcf_digest']} is not the JAX package's "
             f"{PHASE23_VCF}")
    msa = {"families": len(fams), "sequences": sum(map(len, fams)),
           "lengths": [min(len(f[0]) for f in fams), max(len(f[0]) for f in fams)]}
    gotoh_forward_plane.launches = 0
    gotoh_forward_plane.launch_shapes.clear()
    _runs_from_plane.launches = 0
    _runs_from_plane.launch_shapes.clear()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    rows = {}
    for i in order:
        rows[i] = BestStarMultipleSequenceAlignmentAlgorithm(device=device) \
            .calculate_multiple_sequence_alignment(fams[i])
    torch.cuda.synchronize()
    msa["s"] = round(time.perf_counter() - t1, 3)
    msa["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
    launches = {"gotoh": gotoh_forward_plane.launches, "walk": _runs_from_plane.launches}
    if not launches["gotoh"]:
        fail("phase 23: the MSA launched no Gotoh kernel")
    walk_route((gotoh_forward_plane, _runs_from_plane), "runs", "phase 23 MSA")
    shapes = Counter()
    for (_ends, B, Lq, Ls, kern), n in gotoh_forward_plane.launch_shapes.items():
        shapes[B, Lq, Ls, kern] += n
    msa["launches"] = launches
    by_kernel = Counter()
    for (_, _, _, kern), n in shapes.items():
        by_kernel[kern] += n
    msa["by_kernel"] = dict(by_kernel)
    log(f"phase 23 MSA launches by shape: {shapes_text(shapes)}")
    if by_kernel["wide"] or (over_seg and not by_kernel["cluster"]):
        fail(f"phase 23: the families over {SEG_MAX_LS} bp did not take the cluster "
             f"kernel: {dict(by_kernel)}")
    for i, r in rows.items():
        if len({len(a) for a in r}) != 1 or [a.replace("-", "") for a in r] != fams[i]:
            fail(f"phase 23: family {i}'s MSA rows are not its inputs with gaps, of one width")
    msa["digest"] = msa_digest([rows[i] for i in range(len(fams))])
    if msa["digest"] != PHASE23_MSA:
        fail(f"phase 23: the MSA rows {msa['digest']} are not the JAX package's {PHASE23_MSA}")
    cpu, cpu_s = cpu_smallest.result("phase 23")
    for i, rows_cpu in zip(order[:5], cpu):
        if rows_cpu != rows[i]:
            fail(f"phase 23: family {i}'s MSA rows differ between {device} and cpu")
    msa["cpu_5_smallest_s"] = round(cpu_s, 3)
    if cpu_over_seg:
        i = over_seg[0]
        (cpu,), cpu_s = cpu_over_seg.result("phase 23")
        if cpu != rows[i]:
            fail(f"phase 23: family {i}'s MSA rows (over {SEG_MAX_LS} bp) differ between "
                 f"{device} and cpu")
        msa["cpu_over_seg"] = dict(family=i, sequences=len(fams[i]),
                                   widest=max(map(len, fams[i])), cpu_s=round(cpu_s, 3))
    # the launched batch with the most cells (a family's first all-pairs
    # chunk), timed with its plain version; the same for the cluster
    # kernel's (subjects over SEG_MAX_LS), where a family reaches it
    from ngsepcore_tpu_torch.clustering.msa import PLANE_BUDGET_BYTES
    from ngsepcore_tpu_torch.core.sequences import encode_dna

    def first_chunk(i):
        L = -(-max(map(len, fams[i])) // 32) * 32
        n = len(fams[i])
        return min(n * (n - 1) // 2, max(1, PLANE_BUDGET_BYTES // (4 * L * L))), L

    def timed(fams_of):
        fam = max(fams_of, key=lambda i: first_chunk(i)[0] * first_chunk(i)[1] ** 2)
        cs = [encode_dna(x) for x in fams[fam]]
        pairs = [(cs[a], cs[b]) for a in range(len(cs)) for b in range(a + 1, len(cs))]
        return _msa_shape_entry(f"family {fam}", pairs[: first_chunk(fam)[0]], device)

    timing = timed(order)
    msa["timed_shape"] = timing[0]["shape"]
    over = [i for i in order if first_chunk(i)[1] > SEG_MAX_LS]
    cluster = None
    if over:
        # the cluster kernel's batch, its own kernels-line entry, with the
        # walk behind it beside the entry's walk
        cluster, c_w = timed(over)
        B, _, Ls = map(int, cluster["shape"].split("x"))
        cluster["layout"] = "N {}, W {}, K {}".format(*device_cluster_layout(B, Ls))
        timing[1].update({f"over_seg_{k}": c_w[k] for k in (
            "shape", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by")})
    log(f"phase 23 MSA of 30 repeat families: {json.dumps(msa)}")
    return {"launches": launches, "gotoh": timing[0], "walk": timing[1],
            "cluster": cluster, "cluster_launches": by_kernel["cluster"],
            "report": report, "msa": msa}


# ---------------------------------------------------------------------------
PHASES = ("2", "2b", "2c", "2d", "3", "4", "5", "6", "7", "9", "10", "12", "13", "25", "8",
          "11", "24", "26", "14", "15", "16", "17", "18", "19", "20", "21", "22", "23")
# uses that phase's data
NEEDS = {"6": "4", "8": "5", "10": "5", "11": "5", "13": "5", "24": "5", "25": "5"}


def _chosen(argv):
    """(the phases to run, in PHASES order: all of them with no argument,
    else `--phases 2c,14` and the phases whose data these use; phase 17's
    assembler row).  Phases 0 (device) and 1 (build) always run."""
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of ngsepcore_tpu_torch on one GPU")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: all), e.g. 2c,14")
    ap.add_argument("--asm-row", default="lin100", choices=sorted(ASM_ROWS),
                    help="phase 17's assembler row (default lin100; A = 60x of 15 kb "
                         "over 300 kb)")
    args = ap.parse_args(argv)
    want = {p.strip() for p in args.phases.split(",") if p.strip()}
    bad = want - set(PHASES)
    if bad:
        ap.error(f"unknown phases {sorted(bad)}; known: {','.join(PHASES)}")
    want |= {NEEDS[p] for p in want if p in NEEDS}
    return [p for p in PHASES if p in want], args.asm_row


def main(argv=None) -> None:
    chosen, asm_row = _chosen(sys.argv[1:] if argv is None else argv)
    smi = phase_device()
    import torch

    from ngsepcore_tpu_torch.kernels.hmm import viterbi_log
    from ngsepcore_tpu_torch.kernels.pairwise import _runs_from_plane as run_walk
    from ngsepcore_tpu_torch.kernels.pairwise_cuda import gotoh_forward_plane
    from ngsepcore_tpu_torch.kernels.shear_pileup import shear_hist

    counters = (gotoh_forward_plane, run_walk, shear_hist)
    # the population and read-depth callers count their own three kernels
    pop_counters = (gotoh_forward_plane, run_walk, shear_hist, viterbi_log)
    lr_counters = (gotoh_forward_plane, run_walk)
    phase_build()
    t = {}  # what each phase returns, by phase
    deferred = []  # checks of work left running in the background
    for p in chosen:
        if p in ("20", "21", "22") and "23" in chosen and "23 cpu" not in t:
            # phase 23's CPU-side MSAs (30-80 s of host) end during phases
            # 20-22, so that phase 23 need not wait for them
            t["23 cpu"] = start_msa_cpu()
        if p == "2":
            t[p] = phase_gotoh()
        elif p == "2b":
            t[p] = phase_viterbi()
        elif p == "2c":
            t[p] = phase_walk()
        elif p == "2d":
            t[p] = phase_forward_backward()
        elif p == "3":
            t[p] = phase_shear()
        elif p == "4":
            t[p] = phase_cuda_vs_cpu(counters)
            phase_sorted_key_50kb(counters, t[p])
            phase_anchor_30x(counters)
        elif p == "5":
            t[p] = phase_real_size(counters)
            t["5 launches"] = t[p][0]
        elif p == "6":
            t[p] = phase_classic(counters, t["4"])
        elif p == "7":
            phase_span(counters)
        elif p == "9":
            t[p], finish = phase_str_50kb(counters)
            deferred.append(finish)
        elif p == "10":
            _, _, _, genome, reads, truth, table, tandem, metrics5 = t["5"]
            str_launches, str_shapes, walk_t2 = phase_str_real_size(
                counters, genome, reads, truth, table, tandem, metrics5)
            t[p] = (str_launches, tier2_launches(str_shapes), walk_t2,
                    phase_tier2_shapes(str_shapes))
        elif p == "12":
            phase_population_small(pop_counters)
        elif p == "13":
            _, _, _, genome, _, truth, table, _, _ = t["5"]
            t[p] = phase_population_real_size(pop_counters, genome, table, truth[2])
        elif p == "25":
            torch.cuda.empty_cache()
            t[p] = phase_mesh(counters, t["5"], t.get("4"), smi)
            torch.cuda.empty_cache()
        elif p in ("8", "11"):
            if "d" not in t:  # phase 8's FASTQ and FASTA serve phase 11
                t["5"] = t["5"][:6] + (None,) + t["5"][7:]  # drop the table
                torch.cuda.empty_cache()  # the CLI subprocesses share the card
                t["d"] = tempfile.TemporaryDirectory()
            _, _, fused_records, genome, reads, truth, _, _, _ = t["5"]
            if p == "8":
                phase_cli(t["d"].name, genome, reads, truth, fused_records)
            else:
                phase_kmers(t["d"].name, genome, reads)
        elif p == "24":
            torch.cuda.empty_cache()
            t[p] = phase_rice_sized(counters, t["5"])
            torch.cuda.empty_cache()
        elif p == "26":
            torch.cuda.empty_cache()
            t[p] = phase_real_size(counters, mbp=BENCH_MBP, n_reads=BENCH_N_READS, phase="26",
                                   expect=BENCH_SIZE_RECORDS)[0]  # the rest is freed here
            torch.cuda.empty_cache()
        elif p in ("14", "15"):
            t.pop("5", None)  # phase 5's genome, reads and index are done with
            if "d" in t:
                t.pop("d").cleanup()
            torch.cuda.empty_cache()
            t[p] = (phase_long_reads_small if p == "14"
                    else phase_long_reads_real_size)(lr_counters)
        elif p == "16":
            torch.cuda.empty_cache()
            t[p], finish = phase_assembly_small(lr_counters)
            deferred.append(finish)
        elif p == "17":
            torch.cuda.empty_cache()
            t[p] = phase_assembly_real_size(lr_counters, asm_row)
        elif p == "18":
            torch.cuda.empty_cache()
            phase_imputer_small()
        elif p == "19":
            torch.cuda.empty_cache()
            t[p] = phase_imputer_real_size()
        elif p == "20":
            torch.cuda.empty_cache()
            phase_long_tail_small()
        elif p == "21":
            torch.cuda.empty_cache()
            t[p] = phase_long_tail_real_size()
        elif p == "22":
            torch.cuda.empty_cache()
            phase_gbs_small()
        elif p == "23":
            torch.cuda.empty_cache()
            t[p] = phase_gbs_real_size(msa_cpu=t.pop("23 cpu", None))
    if "d" in t:
        t.pop("d").cleanup()
    for finish in deferred:
        finish()
    log(f"phases {','.join(chosen)} passed; wall {time.perf_counter() - T_START:.1f}s")
    print(json.dumps({"kernels": kernel_entries(t)}), flush=True)
    print(nvidia_smi() or smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


def kernel_entries(t: dict) -> list:
    """The kernels line from the phases' results: each kernel timed in phases
    2-3 at the shape its path launches, with the launches of that path's
    timed run.  A run of some phases only gives the entries it has."""

    def entry(name, source, replaces, n_launches, timing):
        # no one PyTorch call computes any of these functions (the Gotoh
        # plane with packed run pointers, its run-jump walk, the sheared
        # per-position histogram, the Viterbi path)
        out = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches, "max_abs_err": timing["max_abs_err"],
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": None,
        }
        # where the shape came from the run: which one, and which kernel;
        # the Viterbi kernel's measured chain a step and its human-scale
        # batch (one launch, and its sequences' own launches summed);
        # graph_ms, where measured: 20 calls in one CUDA graph, without the
        # launch cost from Python that ms (20 back-to-back calls) includes;
        # the walk's mode, and for the tier3 and hamming modes what they
        # replace: the runs mode alone in a graph, then with the plain
        # post-pass from Python and in a graph; the forward-backward
        # floor's terms and the lane cycles of its exp10 and log10 units
        out.update({k: timing[k] for k in (
            "shape", "kernel", "graph_ms", "mode", "walk_graph_ms", "replaced_ms",
            "replaced_graph_ms", "chain_cycles", "human", "bound_terms_ms",
            "fp64_lane_cycles", "log_form_ms", "log_form_graph_ms") if k in timing})
        out.update({k: v for k, v in timing.items() if k.startswith("over_seg_")})
        return out

    gotoh = ("ngsepcore_tpu_torch/csrc/gotoh_forward.cu",
             "ngsepcore_tpu/kernels/pairwise_pallas.py:243")
    # lax.scans and array passes in the JAX package with no Pallas
    # counterpart, by the mode timed: the walk (:595), in the tier3 mode
    # with dp_stats_runs (:693) and _left_align_rle (:1015), in the hamming
    # mode with dp_stats_runs_hamming (:746)
    walk_replaces = {"runs": "595", "tier3": "595,693,1015", "hamming": "595,746"}
    walk = lambda timing: ("ngsepcore_tpu_torch/csrc/run_walk.cu",
                           "ngsepcore_tpu/kernels/pairwise.py:" + walk_replaces[timing["mode"]])
    g, w, out = t.get("2"), t.get("2c"), []
    if "5 launches" in t and g:
        out.append(entry("gotoh_forward", *gotoh, t["5 launches"]["gotoh_forward_plane"],
                         g["main-path chunk 2048x160x160"]))
    if "5 launches" in t and w:
        # the walk of the fused path's tier 3 (phase 5)
        wt = w["fused tier 3 2048x160x160"]
        out.append(entry("run_walk_fused", *walk(wt), t["5 launches"]["_runs_from_plane"], wt))
    if "6" in t and g:
        # the same kernels on the classic path (phase 6), at its tier-3 shape
        out.append(entry("gotoh_forward_classic", *gotoh, t["6"]["gotoh_forward_plane"],
                         g["classic tier-3 2048x192x192"]))
    if "6" in t and w:
        wt = w["classic tier 3 2048x192x192"]
        out.append(entry("run_walk_classic", *walk(wt), t["6"]["_runs_from_plane"], wt))
    if "10" in t:
        # the tier-2 STR flanks of the known-STR run at full width (phase
        # 10), each side timed at the launched shape that takes most of its
        # Gotoh time; launches from each kernel's own counter
        _, t2_launches, t2_walk, t2 = t["10"]
        for side in ("left", "right"):
            out.append(entry(f"gotoh_forward_tier2_{side}", *gotoh, t2_launches[side],
                             t2[side]))
            out.append(entry(f"run_walk_tier2_{side}", *walk(t2[side]["walk"]),
                             t2_walk[side], t2[side]["walk"]))
    for p, tag in (("15", "long_reads"), ("17", "assembly")):
        if p not in t or not (g and w):
            continue
        # the long-read run (phase 15) and the assembly at user size (phase
        # 17; every polish, correction and phasing pass is a long-read
        # alignment), each kernel timed at the long-read shape that takes
        # most of its time there: launches x the 512-row device time (in a
        # CUDA graph) x rows / 512 (a chunk of fewer rows takes about its
        # share of the 512-row time)
        launches, gotoh_shapes, walk_shapes = t[p]
        per = Counter()
        for (kind, B, Lq, Ls, _), n in gotoh_shapes.items():
            per[kind, Lq] += n * B / 512 * g[f"long reads {kind} 512x{Lq}x{Ls}"]["graph_ms"]
        kind, W = max(per, key=per.get)
        out.append(entry(f"gotoh_forward_{tag}", *gotoh, sum(gotoh_shapes.values()),
                         g[f"long reads {kind} 512x{W}x{W}"]))
        per = Counter()
        for (_, B, Lq, Ls, _, _), n in walk_shapes.items():
            per[Lq] += n * B / 512 * w[f"long reads center 512x{Lq}x{Ls}"]["graph_ms"]
        W = max(per, key=per.get)
        wt = w[f"long reads center 512x{W}x{W}"]
        out.append(entry("run_walk" if p == "15" else f"run_walk_{tag}", *walk(wt),
                         launches["_runs_from_plane"], wt))
    if "9" in t and g:
        # tier 2 over phase 9's 1,500 bp array at 50 kb (the seg kernel at
        # 6-8 warps), timed at a flank chunk over such an array
        out.append(entry("gotoh_forward_long_str", *gotoh, t["9"],
                         g[STR1500_TIMED["left"]]))
    if "5 launches" in t and "3" in t:
        out.append(entry("shear_hist", "ngsepcore_tpu_torch/csrc/shear_hist.cu",
                         "ngsepcore_tpu/kernels/shear_pileup.py:227",
                         t["5 launches"]["shear_hist"], t["3"][1]))
    if "24" in t:
        # the fused path against the rice-sized reference (phase 24, the
        # sorted-key table), timed at the fused path's shapes
        if g:
            out.append(entry("gotoh_forward_rice", *gotoh, t["24"]["gotoh_forward_plane"],
                             g["main-path chunk 2048x160x160"]))
        if w:
            wt = w["fused tier 3 2048x160x160"]
            out.append(entry("run_walk_rice", *walk(wt), t["24"]["_runs_from_plane"], wt))
        if "3" in t:
            out.append(entry("shear_hist_rice", "ngsepcore_tpu_torch/csrc/shear_hist.cu",
                             "ngsepcore_tpu/kernels/shear_pileup.py:227",
                             t["24"]["shear_hist"], t["3"][1]))
    if "26" in t:
        # the fused path at bench.py's size (phase 26), timed at the fused
        # path's shapes
        if g:
            out.append(entry("gotoh_forward_bench", *gotoh, t["26"]["gotoh_forward_plane"],
                             g["main-path chunk 2048x160x160"]))
        if w:
            wt = w["fused tier 3 2048x160x160"]
            out.append(entry("run_walk_bench", *walk(wt), t["26"]["_runs_from_plane"], wt))
        if "3" in t:
            out.append(entry("shear_hist_bench", "ngsepcore_tpu_torch/csrc/shear_hist.cu",
                             "ngsepcore_tpu/kernels/shear_pileup.py:227",
                             t["26"]["shear_hist"], t["3"][1]))
    if "25" in t:
        # the fused path over a mesh of four shards of the card (phase 25's
        # first D = 4 run), timed at the fused path's shapes
        if g:
            out.append(entry("gotoh_forward_mesh", *gotoh, t["25"]["gotoh_forward_plane"],
                             g["main-path chunk 2048x160x160"]))
            out[-1]["launches_by_shard"] = [c["gotoh_forward"] for c in t["25"]["by_shard"]]
        if w:
            wt = w["fused tier 3 2048x160x160"]
            out.append(entry("run_walk_mesh", *walk(wt), t["25"]["_runs_from_plane"], wt))
            out[-1]["launches_by_shard"] = [c["run_walk"] for c in t["25"]["by_shard"]]
    if "13" in t and "2b" in t:
        # a lax.scan in the JAX package, no Pallas counterpart; launches of
        # the read-depth HMM callers at full width (phase 13)
        out.append(entry("viterbi_log", "ngsepcore_tpu_torch/csrc/viterbi.cu",
                         "ngsepcore_tpu/kernels/hmm.py:85",
                         t["13"]["viterbi_log"], t["2b"]))
    if "19" in t and "2d" in t:
        # lax.scans in the JAX package (forward_log :33, backward_log :57,
        # posterior_log :75), vmapped by the imputer; launches of the
        # imputer at its users' size (phase 19), timed at one of its windows
        # beside the floor of the function in any design (fb_bound)
        # ms is the product form's (the imputer's launches), log_form_ms the
        # log form's, which answers inputs outside the product form's range
        out.append(entry("forward_backward", "ngsepcore_tpu_torch/csrc/forward_backward.cu",
                         "ngsepcore_tpu/kernels/hmm.py:33,57,75",
                         t["19"]["launches"], t["2d"]))
        out[-1]["launches_by_form"] = t["19"]["launches_by_form"]
    if "23" in t:
        # the best-star MSA of phase 23's 30 repeat families (all-pairs and
        # centre batches, unit costs, free subject ends): its launches, timed
        # at its launched shape with the most cells
        out.append(entry("gotoh_forward_msa", *gotoh, t["23"]["launches"]["gotoh"],
                         t["23"]["gotoh"]))
        out.append(entry("run_walk_msa", *walk(t["23"]["walk"]),
                         t["23"]["launches"]["walk"], t["23"]["walk"]))
        if t["23"]["cluster"]:
            # the same launches' share over SEG_MAX_LS columns, on the
            # cluster kernel: timed at its batch with the most cells
            out.append(entry("gotoh_forward_cluster_msa", *gotoh,
                             t["23"]["cluster_launches"], t["23"]["cluster"]))
            out[-1]["layout"] = t["23"]["cluster"]["layout"]
    return out


if __name__ == "__main__":
    main()
