// Run-jump traceback over the Gotoh run/pointer plane, one thread an
// alignment.
//
// Replaces ngsepcore_tpu/kernels/pairwise.py:595 (_runs_from_plane), a
// lax.scan over R steps that XLA compiles into a device loop; it has no
// Pallas counterpart.  Semantics are those of the plain version in this
// package, kernels/pairwise.py:_runs_from_plane_ref, step for step:
//
//   from (i, j, k) = (end_i, end_j, start_k), at most R steps:
//     i > 0, j > 0   w = plane[i-1][b][j-1]; run = (w >> (8k+8)) & 255,
//                    src = (w >> 2k) & 3; a run of 255 is saturated: it
//                    moves 254 cells and keeps k, else k = src; emit
//                    (run, k+1) and move i (k = 0, 1) and j (k = 0, 2)
//     i > 0, j == 0  emit (i, INS), i = 0         (the query's head)
//     i == 0, j > 0  emit (j, DEL), j = 0 unless free_start2
//     otherwise      done: this and every later step emits (0, NONE)
//   start_j = j; walk_ok = i == 0 and (j == 0 or free_start2)
//   n_raw = the number of emitted runs of length > 0; the FIRST n_raw
//   emitted entries are reversed into forward order (an entry of length 0
//   among them, which a frozen padding row gives, stays and pushes a later
//   one out); then a left-to-right merge: an entry opens a new run when its
//   length is > 0 and its op differs from the previous ENTRY's op (length
//   0 entries included); entries before the first new run are dropped;
//   n_ops sums every forward entry.
//
// The plane holds 0..2 in every pointer field, so k stays in 0..2 and
// every shift is below 32.  Integer only: the outputs equal the plain
// version's bit for bit.
//
// What bounds it on the H100: each step's address depends on the word the
// previous step loaded, so an alignment is a chain of up to R dependent
// loads, each of at least one L2 hit latency (the plane was just written
// by the Gotoh kernel and mostly sits in the 50 MB L2; a miss costs a
// device-memory latency).  chip_smoke.py takes the L2 hit latency as 260
// cycles at 1.98 GHz (0.131 us), the order that pointer-chase
// microbenchmarks of Hopper report (Luo et al., "Benchmarking and
// Dissecting the Nvidia Hopper GPU Architecture", 2024), and measures the
// kernel's own step on a B = 1 chain beside it.  The bytes are small:
// one 4-byte word read a step, B*R*8 bytes of runs written.  The chains of
// different alignments are independent, so many in flight hide each
// other's latency; one thread an alignment gives B chains at once.
//
// Design: one thread walks one alignment and stops as soon as it is done
// (the plain version's early exit is a host sync every 8 steps; here there
// is none).  Raw runs go straight into the thread's (R,) output rows: R
// reaches Lq + Ls (about 1,200) on the tier-2 path, too many for
// registers.  The thread then reverses and merges them in place (a merged
// run's slot never passes the entry being read) and zeroes the rest of
// its rows.  Plane offsets are 64-bit: 1024 x 2048 x 1024 cells is 2^31.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 32;  // one warp a block: the rows spread over SMs
constexpr int kOpIns = 2;
constexpr int kOpDel = 3;

__global__ void __launch_bounds__(kThreads)
run_walk_kernel(const uint32_t* __restrict__ plane,
                const int* __restrict__ end_i, const int* __restrict__ end_j,
                const int* __restrict__ start_k, int B, int Ls, int R,
                bool emit_lead_del, int* __restrict__ rop,
                int* __restrict__ rlen, int* __restrict__ n_runs,
                int* __restrict__ n_ops, int* __restrict__ start_j,
                unsigned char* __restrict__ walk_ok) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t row_stride = (size_t)B * Ls;  // plane[i][b][j] -> plane[i+1][b][j]
  const uint32_t* col0 = plane + (size_t)b * Ls;
  int* op_row = rop + (size_t)b * R;
  int* len_row = rlen + (size_t)b * R;
  int i = end_i[b];
  int j = end_j[b];
  int k = start_k[b];

  // 1. the walk, from the end of the alignment: raw entries in order
  int steps = 0;
  int n_raw = 0;
  for (; steps < R; ++steps) {
    int op;
    int ln;
    if (i > 0 && j > 0) {
      const uint32_t w = col0[(size_t)(i - 1) * row_stride + (j - 1)];
      const int src = (int)((w >> (2 * k)) & 3u);
      const int run = (int)((w >> (8 * k + 8)) & 255u);
      const bool sat = run == 255;
      const int r = sat ? 254 : run;
      op = k + 1;
      ln = r;
      if (k == 0 || k == 1) i -= r;
      if (k == 0 || k == 2) j -= r;
      if (!sat) k = src;
    } else if (i > 0 && j == 0) {
      op = kOpIns;
      ln = i;
      i = 0;
    } else if (i == 0 && j > 0 && emit_lead_del) {
      op = kOpDel;
      ln = j;
      j = 0;
    } else {
      break;
    }
    op_row[steps] = op;
    len_row[steps] = ln;
    n_raw += ln > 0;
  }
  start_j[b] = j;
  walk_ok[b] = i == 0 && (j == 0 || !emit_lead_del);

  // 2. the first n_raw entries (n_raw <= steps) into forward order
  for (int a = 0, z = n_raw - 1; a < z; ++a, --z) {
    const int la = len_row[a], oa = op_row[a];
    len_row[a] = len_row[z];
    op_row[a] = op_row[z];
    len_row[z] = la;
    op_row[z] = oa;
  }

  // 3. merge adjacent equal ops; slot `rank` < t is written after entry t
  // is read, so the merge runs in place
  int prev = -1;
  int rank = -1;
  int cur_len = 0;
  int cur_op = 0;
  int total = 0;
  for (int t = 0; t < n_raw; ++t) {
    const int ln = len_row[t];
    const int op = op_row[t];
    total += ln;
    if (ln > 0 && op != prev) {
      if (rank >= 0) {
        len_row[rank] = cur_len;
        op_row[rank] = cur_op;
      }
      ++rank;
      cur_len = 0;
      cur_op = op;
    }
    if (rank >= 0) cur_len += ln;
    prev = op;
  }
  if (rank >= 0) {
    len_row[rank] = cur_len;
    op_row[rank] = cur_op;
  }
  for (int t = rank + 1; t < R; ++t) {
    len_row[t] = 0;
    op_row[t] = 0;
  }
  n_runs[b] = rank + 1;
  n_ops[b] = total;
}

}  // namespace

// plane (Lq, B, Ls) int32 holding uint32 bits; end_i, end_j, start_k (B,)
// int32; outputs rop, rlen (B, R) int32, n_runs, n_ops, start_j (B,) int32,
// walk_ok (B,) bytes 0/1.  Launches on `stream`, returns cudaGetLastError().
extern "C" int run_walk_launch(const void* plane, const void* end_i,
                               const void* end_j, const void* start_k, int B,
                               int Ls, int R, int free_start2, void* rop,
                               void* rlen, void* n_runs, void* n_ops,
                               void* start_j, void* walk_ok, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (Ls < 1 || R < 0) return (int)cudaErrorInvalidValue;
  run_walk_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const uint32_t*)plane, (const int*)end_i, (const int*)end_j,
      (const int*)start_k, B, Ls, R, free_start2 == 0, (int*)rop, (int*)rlen,
      (int*)n_runs, (int*)n_ops, (int*)start_j, (unsigned char*)walk_ok);
  return (int)cudaGetLastError();
}
