// Run-jump traceback over the Gotoh run/pointer plane, one thread an
// alignment, with the tier-3 and long-read statistics as its epilogue.
//
// Replaces ngsepcore_tpu/kernels/pairwise.py:595 (_runs_from_plane), a
// lax.scan over R steps that XLA compiles into a device loop, and the
// post-passes that follow it there, dp_stats_runs (:693, with
// _left_align_rle :1015) and dp_stats_runs_hamming (:746); none has a
// Pallas counterpart.  Semantics are those of the plain versions in this
// package, kernels/pairwise.py, step for step.  The walk
// (_runs_from_plane_ref):
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
// Three epilogues, a template parameter (Mode), pick what is written:
//
//   kRuns     the merged runs (rop, rlen, zero past n_runs), n_runs, n_ops,
//             start_j, walk_ok: _runs_from_plane (tier 2's budget Lq + Ls)
//   kTier3    dp_stats_runs: mism, has_gap, the left-aligned rle, n_runs,
//             n_ops, start_j, la_fallback
//   kHamming  dp_stats_runs_hamming: rle, n_runs, mism, start_j, walk_ok
//
// Statistics over the n merged runs: m_cnt and gap_len sum the M and I/D
// lengths, k_all counts the I/D runs, k_runs those right after an M run;
// sub_mm = (m_cnt - score - 2 k_all - gap_len) >> 1 (arithmetic).
// Tier 3: mism = sub_mm + 2 k_runs - 2 [last run is I/D], 32000 where the
// walk ran out of budget; hamming: mism = sub_mm + gap_len, else 30000.
// rle[t] = (int16)(op | len << 2), 0 past n_runs.
//
// Tier 3's left-alignment is _left_align_rle's sequential pass over slots
// t = 1..R-1 in its order, without its tables.  A gap run t (op I or D,
// length l, cursor p: the query (I) or subject (D) offset where the run
// starts in the original RLE) after an M run shifts left by
//     k = min(brl_l(clamp(p-1, 0, L-1)), lens[t-1], p)
// where lens holds the lengths shifted so far and brl_l(pos) counts the
// consecutive u = pos, pos-1, ..., 0 with eq_l(u) = (u + l < L and
// x[u] == x[u+l]) over the row's query (I) or subject (D) codes x of
// width L (padding code 4 equals 4).  Here it is counted directly, by a
// backward compare that stops after min(lens[t-1], p) equal pairs, which
// gives the same minimum.  k is 0 unless 1 <= l <= LA_LMAX; a k > 0 whose
// next slot is not an M run sets la_fallback and is dropped; otherwise
// lens[t-1] -= k and lens[t+1] += k.  A gap longer than LA_LMAX sets
// la_fallback (n_runs > R, the plain version's other case, cannot happen:
// the merge gives at most R runs).  A shift moves only slots t-1 and t+1,
// so the pass keeps three slots in registers: slot t-1 is final once slot
// t is done and its rle is written then.  The cursors advance by the
// original lengths.
//
// The plane holds 0..2 in every pointer field, so k stays in 0..2 and
// every shift is below 32.  Integer only: the outputs equal the plain
// versions' bit for bit.
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
// one 4-byte word read a step, the runs or the statistics written (tier 3
// also reads the codes around each gap, at most the query and subject
// rows).  The chains of different alignments are independent, so many in
// flight hide each other's latency; one thread an alignment gives B chains
// at once.  The epilogue is short beside the walk (a few passes over at
// most R runs that the thread has just written, L1 and L2 hits), and it
// takes the plain post-pass's hundreds of launches a chunk off the host.
//
// Design: one thread walks one alignment and stops as soon as it is done
// (the plain version's early exit is a host sync every 8 steps; here there
// is none).  Raw runs go straight into the thread's (R,) rows of rop and
// rlen (the output in kRuns, scratch in the other modes): R reaches
// Lq + Ls (about 1,200) on the tier-2 path, too many for registers.  The
// thread then reverses and merges them in place (a merged run's slot never
// passes the entry being read) and runs the epilogue over them.  Plane
// offsets are 64-bit: 1024 x 2048 x 1024 cells is 2^31.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 32;  // one warp a block: the rows spread over SMs
constexpr int kOpMatch = 1;
constexpr int kOpIns = 2;
constexpr int kOpDel = 3;
constexpr int kLaLmax = 16;  // kernels/pairwise.LA_LMAX
constexpr int kTier3WalkFail = 32000;
constexpr int kHammingWalkFail = 30000;

enum Mode { kRuns = 0, kTier3 = 1, kHamming = 2 };

struct Outputs {
  int* rop;  // (B, R): the runs (kRuns) or scratch
  int* rlen;
  int* n_runs;  // (B,) each
  int* n_ops;
  int* start_j;
  unsigned char* walk_ok;  // kRuns, kHamming
  int* mism;               // kTier3, kHamming
  int16_t* rle;            // (B, R), kTier3, kHamming
  signed char* has_gap;    // kTier3
  signed char* la_fallback;
};

// min(cap, brl_l(pos)) over the codes x of one row of width L: the count
// of consecutive u = pos, pos-1, ... >= 0 with u + l < L and
// x[u] == x[u + l], stopped after cap of them
__device__ __forceinline__ int shift_room(const signed char* __restrict__ x,
                                          int L, int l, int pos, int cap) {
  int n = 0;
  for (int u = pos; n < cap && u >= 0 && u + l < L && x[u] == x[u + l]; --u) ++n;
  return n;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
run_walk_kernel(const uint32_t* __restrict__ plane,
                const int* __restrict__ end_i, const int* __restrict__ end_j,
                const int* __restrict__ start_k, const int* __restrict__ score,
                const signed char* __restrict__ query,
                const signed char* __restrict__ subject, int B, int Lq, int Ls,
                int R, bool emit_lead_del, Outputs out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t row_stride = (size_t)B * Ls;  // plane[i][b][j] -> plane[i+1][b][j]
  const uint32_t* col0 = plane + (size_t)b * Ls;
  int* op_row = out.rop + (size_t)b * R;
  int* len_row = out.rlen + (size_t)b * R;
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
  const int sj = j;
  const bool walk_ok = i == 0 && (j == 0 || !emit_lead_del);
  out.start_j[b] = sj;
  if (kMode != kTier3) out.walk_ok[b] = walk_ok;

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
  const int n = rank + 1;
  out.n_runs[b] = n;
  if (kMode != kHamming) out.n_ops[b] = total;
  if (kMode == kRuns) {
    for (int t = n; t < R; ++t) {
      len_row[t] = 0;
      op_row[t] = 0;
    }
    return;
  }

  // 4. the statistics (and, tier 3, the left-alignment) over the n runs
  int16_t* rle_row = out.rle + (size_t)b * R;
  int m_cnt = 0;
  int gap_len = 0;
  int k_all = 0;
  int k_runs = 0;
  if (kMode == kHamming) {
    for (int t = 0; t < n; ++t) {
      const int op = op_row[t];
      const int ln = len_row[t];
      const bool gap = op == kOpIns || op == kOpDel;
      if (op == kOpMatch) m_cnt += ln;
      if (gap) {
        gap_len += ln;
        ++k_all;
      }
      rle_row[t] = (int16_t)(op | (ln << 2));
    }
    for (int t = n; t < R; ++t) rle_row[t] = 0;
    const int sub_mm = (m_cnt - score[b] - 2 * k_all - gap_len) >> 1;
    out.mism[b] = walk_ok ? sub_mm + gap_len : kHammingWalkFail;
    return;
  }

  const signed char* q_row = query + (size_t)b * Lq;
  const signed char* s_row = subject + (size_t)b * Ls;
  bool fallback = false;
  int pq = 0;        // query offset where slot t starts (original RLE)
  int ps = sj;       // subject offset
  int prev_op = 0;   // slot t-1: op and length shifted so far
  int prev_len = 0;
  int carry = 0;     // what slot t-1's shift added to slot t
  for (int t = 0; t < n; ++t) {
    const int op = op_row[t];
    const int ln = len_row[t];
    const bool is_ins = op == kOpIns;
    const bool gap = is_ins || op == kOpDel;
    if (op == kOpMatch) m_cnt += ln;
    if (gap) {
      gap_len += ln;
      ++k_all;
      k_runs += prev_op == kOpMatch;
      fallback |= ln > kLaLmax;
    }
    int k = 0;
    if (t >= 1) {
      const bool next_m = t + 1 < n && op_row[t + 1] == kOpMatch;
      if (gap && prev_op == kOpMatch && ln >= 1 && ln <= kLaLmax) {
        const int p = is_ins ? pq : ps;
        const int L = is_ins ? Lq : Ls;
        const int pos = min(max(p - 1, 0), L - 1);
        k = shift_room(is_ins ? q_row : s_row, L, ln, pos, min(prev_len, p));
      }
      fallback |= k > 0 && !next_m;
      if (!next_m) k = 0;
      prev_len -= k;
      rle_row[t - 1] = (int16_t)(prev_op | (prev_len << 2));
    }
    if (is_ins || op == kOpMatch) pq += ln;
    if (op == kOpDel || op == kOpMatch) ps += ln;
    prev_op = op;
    prev_len = ln + carry;
    carry = k;
  }
  if (n > 0) rle_row[n - 1] = (int16_t)(prev_op | (prev_len << 2));
  for (int t = n; t < R; ++t) rle_row[t] = 0;
  const bool ends_gap = n > 0 && (prev_op == kOpIns || prev_op == kOpDel);
  const int sub_mm = (m_cnt - score[b] - 2 * k_all - gap_len) >> 1;
  const int mism = sub_mm + 2 * k_runs - 2 * (int)ends_gap;
  out.mism[b] = walk_ok ? mism : kTier3WalkFail;
  out.has_gap[b] = k_all > 0;
  out.la_fallback[b] = fallback;
}

}  // namespace

// plane (Lq, B, Ls) int32 holding uint32 bits; end_i, end_j, start_k, score
// (B,) int32; query (B, Lq) and subject (B, Ls) int8 codes (mode 1 only).
// mode 0 (runs): rop, rlen (B, R) int32 out, n_runs, n_ops, start_j (B,)
// int32, walk_ok (B,) bytes 0/1.  mode 1 (tier 3): rop, rlen scratch,
// n_runs, n_ops, start_j, mism (B,) int32, rle (B, R) int16, has_gap and
// la_fallback (B,) int8.  mode 2 (hamming): rop, rlen scratch, n_runs,
// start_j, mism, walk_ok, rle.  Pointers a mode does not use may be null.
// Launches on `stream`, returns cudaGetLastError().
extern "C" int run_walk_launch(const void* plane, const void* end_i,
                               const void* end_j, const void* start_k,
                               const void* score, const void* query,
                               const void* subject, int B, int Lq, int Ls,
                               int R, int free_start2, int mode, void* rop,
                               void* rlen, void* n_runs, void* n_ops,
                               void* start_j, void* walk_ok, void* mism,
                               void* rle, void* has_gap, void* la_fallback,
                               void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (Ls < 1 || R < 0 || mode < kRuns || mode > kHamming)
    return (int)cudaErrorInvalidValue;
  if (mode == kTier3 && (Lq < 1 || !query || !subject))
    return (int)cudaErrorInvalidValue;
  Outputs out{(int*)rop,          (int*)rlen,       (int*)n_runs,
              (int*)n_ops,        (int*)start_j,    (unsigned char*)walk_ok,
              (int*)mism,         (int16_t*)rle,    (signed char*)has_gap,
              (signed char*)la_fallback};
  const dim3 grid((B + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool lead_del = free_start2 == 0;
#define RUN_WALK_ARGS                                                        \
  (const uint32_t*)plane, (const int*)end_i, (const int*)end_j,              \
      (const int*)start_k, (const int*)score, (const signed char*)query,      \
      (const signed char*)subject, B, Lq, Ls, R, lead_del, out
  if (mode == kRuns) {
    run_walk_kernel<kRuns><<<grid, kThreads, 0, s>>>(RUN_WALK_ARGS);
  } else if (mode == kTier3) {
    run_walk_kernel<kTier3><<<grid, kThreads, 0, s>>>(RUN_WALK_ARGS);
  } else {
    run_walk_kernel<kHamming><<<grid, kThreads, 0, s>>>(RUN_WALK_ARGS);
  }
#undef RUN_WALK_ARGS
  return (int)cudaGetLastError();
}
