// Log-space Viterbi decoding of dense-emission HMMs: one warp a sequence,
// every sequence of a call in one launch.
//
// Counterpart of ngsepcore_tpu/kernels/hmm.py:85 (viterbi_log), which the
// JAX package writes as two lax.scan loops that XLA compiles into device
// loops; it has no Pallas kernel.  Semantics are those of
// kernels/hmm.py:viterbi_log_ref in this package, for each sequence:
//
//   delta[0][j]  = start[j] + emit[0][j]
//   back[t-1][j] = first i maximising delta[t-1][i] + trans[t-1][i][j]
//   delta[t][j]  = that maximum + emit[t][j]
//   path[T-1]    = first j maximising delta[T-1][j];  best = that maximum
//   path[t-1]    = back[t-1][path[t]]
//
// where a step's maximum orders -0.0 below +0.0, as the JAX package's
// jnp.max does.  Only f64 additions, comparisons and sign-bit ANDs occur,
// so path and best equal the plain version's bit for bit (the sign of a
// zero included); -inf entries behave as in IEEE arithmetic and a NaN never
// wins a comparison (the inputs must hold none).
//
// Layout (kernels/hmm.py:ragged_layout): the emissions of all sequences are
// concatenated, (sum T, S); offsets[0..n] are the first row of each
// sequence (of its emissions and of its path) and offsets[n+1..2n+1] the
// first 64-bit word of its back pointers, ceil((T-1)/8) x S words a
// sequence.  start is (n, S) and trans (n, S, S), one matrix a sequence
// shared by its steps, or (T-1, S, S) per step for a batch of one.
//
// What bounds it: the recurrence is a serial chain over T (46,000 steps at
// 4.6 Mbp in 100 bp bins; 2.49 M on the longest human chromosome) of S <= 32
// values; the bytes (T*S*9 + 4*T) are nothing beside it.  Lane j owns state
// j.  A step's chain is the exchange that brings every lane the previous
// deltas (a store to shared memory, __syncwarp and broadcast 16-byte loads:
// ceil(S/2) + 1 instructions, which beat f64 shuffles, 2 S instructions, at
// every S timed; PERF.md), the add of the transition,
// ceil(log2 S) levels of a compare-select tree and the add of the emission;
// chip_smoke.py's viterbi_latencies measures each link on the card.
// Everything else is kept off that chain:
//  - the tree's nodes are compare-selects (v > x ? v : x, the left range
//    keeps a tie: the value bits and the index of the first maximum, as a
//    fold in ascending i).  The index rides beside the value at one integer
//    select a node, off the chain.  f64 fmax is no shorter on sm_90: ptxas
//    expands it to a compare and selects with NaN and signed-zero fixes;
//  - jnp.max's maximum has the first maximum m's value, and its sign bit
//    is the AND of every candidate's (m is -0.0 where a +0.0 ties with it;
//    otherwise the signs agree).  So the step adds z + e to m, where z is
//    the zero of that sign: m + (z + e) is jnp.max's maximum plus e, since
//    z + e is e unless e is a zero.  The AND of the candidates' high words
//    (LOP3s) and z + e run beside the tree;
//  - S <= 8 with shared transitions is a template of exact S, so a step
//    exchanges and compares S candidates, not a padded 8;
//  - whole blocks of 8 steps run without a branch, so that a step's back
//    pointer and its packing issue beside the next steps' chains;
//  - emissions (and per-step transition matrices) are staged a chunk ahead
//    into a double-buffered ring in shared memory by cp.async, so a step
//    never waits on device memory; a shared transition column sits in
//    registers for the whole sequence;
//  - a lane packs a block's 8 back pointers into one 64-bit word (byte u =
//    step u of the block) that leaves in one store nobody waits for.
// The backtrace runs in the same launch: chunks of back-pointer words are
// copied to shared memory by the whole warp, lane 0 walks their bytes
// there, and the warp writes the chunk of the path back coalesced.
//
// VITERBI_SKIP_BACKTRACE and VITERBI_SKIP_BACK_STORES take those parts out
// of the launch (the path is then not written); viterbi_bench.py builds with
// them to say where the time goes.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kMaxStates = 32;
constexpr int kAhead = 8;         // steps a block: 8 back pointers a 64-bit word
constexpr int kChunkBlocks = 16;  // blocks of back pointers per backtrace chunk
constexpr unsigned kFull = 0xffffffffu;
static_assert(kAhead == 8, "a block's back pointers fill the bytes of one 64-bit word");

// steps a staging buffer holds (a multiple of kAhead, so that a chunk
// starts a back-pointer word), and its doubles: kSteps emission rows of
// kCap, then per step a kCap x kCap transition matrix
template <int kCap, bool kPerStep>
struct Ring {
  static constexpr int kSteps = kPerStep ? (kCap <= 8 ? 32 : 8) : (kCap <= 8 ? 256 : 64);
  static constexpr int kDoubles = kSteps * (kCap + (kPerStep ? kCap * kCap : 0));
  static constexpr size_t kBytes = 2 * kDoubles * sizeof(double);  // two buffers
  static_assert(kSteps % kAhead == 0, "chunks start back-pointer words");
};

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// copy steps [t_lo, t_lo + n) of one sequence into a staging buffer: their
// emission rows and, per step, the transition matrix into step t
template <int kCap, bool kPerStep>
__device__ __forceinline__ void stage(double* buf, const double* emit, const double* trans,
                                      int S, int t_lo, int n, int lane) {
  const double* e = emit + (size_t)t_lo * S;
  for (int k = lane; k < n * S; k += 32) cp_async8(buf + k, e + k);
  if (kPerStep) {
    const double* tr = trans + (size_t)(t_lo - 1) * S * S;
    double* bt = buf + Ring<kCap, kPerStep>::kSteps * kCap;
    for (int k = lane; k < n * S * S; k += 32) cp_async8(bt + k, tr + k);
  }
  cp_async_commit();
}

// the first maximum of v[0..kN) and its index: a tree of compare-selects
// over adjacent ranges in which the left one keeps a tie (the same value
// bits and index as a fold in ascending i with a strict '>'); the index
// rides beside the value, off its chain
template <int kN>
__device__ __forceinline__ double first_max(const double (&v)[kN], int& arg) {
  double m[kN];
  int a[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    m[i] = v[i];
    a[i] = i;
  }
#pragma unroll
  for (int w = 1; w < kN; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < kN; i += 2 * w) {
      const bool up = m[i + w] > m[i];
      m[i] = up ? m[i + w] : m[i];
      a[i] = up ? a[i + w] : a[i];
    }
  }
  arg = a[0];
  return m[0];
}

// kCap: exact S (kExact) or a padded 8 or 32 for S up to it (candidates
// from S up are -inf, which never come first among equals)
template <int kCap, bool kExact, bool kPerStep>
__global__ void __launch_bounds__(32)
viterbi_kernel(const double* __restrict__ log_start, const double* __restrict__ log_trans,
               const double* __restrict__ log_emit, const long long* __restrict__ offsets,
               int n_seq, int S_arg, unsigned long long* back, int* __restrict__ path,
               double* __restrict__ best) {
  using R = Ring<kCap, kPerStep>;
  extern __shared__ double ring[];
  __shared__ unsigned long long back_s[kChunkBlocks * kMaxStates];
  __shared__ int path_s[kChunkBlocks * kAhead];
  __shared__ __align__(16) double xs[2 * 32];  // the exchange of deltas, by parity
  const int S = kExact ? kCap : S_arg;
  const int lane = threadIdx.x;
  const bool live = lane < S;
  // idle lanes mirror the last state: they exchange along and never store
  const int j = live ? lane : S - 1;
  const int seq = blockIdx.x;
  const size_t row0 = (size_t)offsets[seq];
  const int T = (int)(offsets[seq + 1] - offsets[seq]);
  const int SS = S * S;
  const double* start = log_start + (size_t)seq * S;
  const double* trans = log_trans + (kPerStep ? 0 : (size_t)seq * SS);
  const double* emit = log_emit + row0 * S;
  unsigned long long* bk = back + offsets[n_seq + 1 + seq];
  int* out = path + row0;
  const int n_blocks = (T - 1 + kAhead - 1) / kAhead;

  // column j of the transitions, padded with -inf
  double trc[kCap];
  if (!kPerStep) {
#pragma unroll
    for (int i = 0; i < kCap; ++i) trc[i] = kExact || i < S ? trans[i * S + j] : -CUDART_INF;
  }
  double delta = start[j] + emit[j];

  const int n_steps = T - 1;
  const int n_chunks = (n_steps + R::kSteps - 1) / R::kSteps;
  if (n_chunks > 0) stage<kCap, kPerStep>(ring, emit, trans, S, 1, min(R::kSteps, n_steps), lane);
  for (int c = 0; c < n_chunks; ++c) {
    const double* be = ring + (c & 1) * R::kDoubles;
    const double* bt = be + R::kSteps * kCap;
    const int t_lo = 1 + c * R::kSteps;
    const int n = min(R::kSteps, T - t_lo);
    if (c + 1 < n_chunks) {
      stage<kCap, kPerStep>(ring + ((c + 1) & 1) * R::kDoubles, emit, trans, S,
                            t_lo + R::kSteps, min(R::kSteps, T - t_lo - R::kSteps), lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies of this chunk have landed
    // one step of the recurrence at row u of the chunk; returns the back pointer
    auto step = [&](int u, double e_u) -> int {
      if constexpr (kPerStep) {
        const double* tr = bt + u * SS + j;
#pragma unroll
        for (int i = 0; i < kCap; ++i) trc[i] = kExact || i < S ? tr[i * S] : -CUDART_INF;
      }
      double* x = xs + (u & 1) * 32;
      x[lane] = delta;
      __syncwarp();
      double cand[kCap];
#pragma unroll
      for (int i = 0; i + 1 < kCap; i += 2) {
        const double2 v = *reinterpret_cast<const double2*>(x + i);
        cand[i] = v.x + trc[i];
        cand[i + 1] = v.y + trc[i + 1];
      }
      if constexpr (kCap % 2 == 1) cand[kCap - 1] = x[kCap - 1] + trc[kCap - 1];
      unsigned sign = 0x80000000u;  // the AND of the candidates' sign bits
#pragma unroll
      for (int i = 0; i < kCap; ++i) sign &= (unsigned)__double2hiint(cand[i]);
      int arg;
      const double m = first_max(cand, arg);
      delta = m + (__hiloint2double((int)sign, 0) + e_u);
      return arg;
    };
    auto store = [&](int u0, unsigned long long packed) {
#ifndef VITERBI_SKIP_BACK_STORES
      if (live) bk[(size_t)((t_lo - 1 + u0) / kAhead) * S + lane] = packed;
#endif
    };
    // whole blocks of kAhead steps without a branch, so that a step's back
    // pointer and packing issue beside the next steps' chains
    int u0 = 0;
    for (; u0 + kAhead <= n; u0 += kAhead) {
      double e[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) e[u] = be[(u0 + u) * S + j];
      unsigned long long packed = 0;
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        packed |= (unsigned long long)step(u0 + u, e[u]) << (8 * u);
      store(u0, packed);
    }
    if (u0 < n) {  // the sequence's last, partial block
      unsigned long long packed = 0;
      for (int u = 0; u0 + u < n; ++u)
        packed |= (unsigned long long)step(u0 + u, be[(u0 + u) * S + j]) << (8 * u);
      store(u0, packed);
    }
    __syncwarp();  // every lane is done with the buffer the next chunk refills
  }

  // first maximum of the last deltas, the same in every lane
  double top = __shfl_sync(kFull, delta, 0);
  int state = 0;
  for (int i = 1; i < S; ++i) {
    const double c = __shfl_sync(kFull, delta, i);
    if (c > top) {
      top = c;
      state = i;
    }
  }
  if (lane == 0) {
    best[seq] = top;
    out[T - 1] = state;
  }
  // the other lanes' back pointers become visible to the whole warp
  __syncwarp();

#if !defined(VITERBI_SKIP_BACKTRACE) && !defined(VITERBI_SKIP_BACK_STORES)
  // row r = 8 b + u of the back pointers (byte u of block b's word of a
  // state) maps the state at step r + 1 to the state at step r
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(back_s);
  for (int b_hi = n_blocks; b_hi > 0; b_hi -= kChunkBlocks) {
    const int b_lo = max(0, b_hi - kChunkBlocks);
    const int n_words = (b_hi - b_lo) * S;
    for (int k = lane; k < n_words; k += 32) back_s[k] = bk[(size_t)b_lo * S + k];
    __syncwarp();
    const int r_lo = b_lo * kAhead;
    const int n = min(b_hi * kAhead, T - 1) - r_lo;
    if (lane == 0) {
      for (int q = n - 1; q >= 0; --q) {
        state = bytes[(((q >> 3) * S + state) << 3) + (q & 7)];
        path_s[q] = state;
      }
    }
    __syncwarp();
    state = __shfl_sync(kFull, state, 0);
    for (int k = lane; k < n; k += 32) out[r_lo + k] = path_s[k];
    __syncwarp();
  }
#endif
}

template <int kCap, bool kExact, bool kPerStep>
int launch(const void* log_start, const void* log_trans, const void* log_emit,
           const void* offsets, int n_seq, int S, void* back, void* path, void* best,
           cudaStream_t stream) {
  auto kernel = viterbi_kernel<kCap, kExact, kPerStep>;
  constexpr size_t smem = Ring<kCap, kPerStep>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<n_seq, 32, smem, stream>>>(
      (const double*)log_start, (const double*)log_trans, (const double*)log_emit,
      (const long long*)offsets, n_seq, S, (unsigned long long*)back, (int*)path,
      (double*)best);
  return (int)cudaGetLastError();
}

}  // namespace

// n_seq sequences of S states in one launch (layout above); back is the
// back-pointer scratch of offsets[2n+1] 64-bit words, path (sum T) int32,
// best (n) f64.  per_step != 0: trans is (T-1, S, S) and n_seq must be 1.
extern "C" int viterbi_launch(const void* log_start, const void* log_trans,
                              const void* log_emit, const void* offsets, int n_seq, int S,
                              int per_step, void* back, void* path, void* best,
                              void* stream) {
  if (n_seq <= 0) return (int)cudaGetLastError();
  if (S < 1 || S > kMaxStates || (per_step && n_seq != 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define VITERBI_ARGS log_start, log_trans, log_emit, offsets, n_seq, S, back, path, best, st
  if (per_step)
    return S <= 8 ? launch<8, false, true>(VITERBI_ARGS) : launch<32, false, true>(VITERBI_ARGS);
  switch (S) {
    case 1: return launch<1, true, false>(VITERBI_ARGS);
    case 2: return launch<2, true, false>(VITERBI_ARGS);
    case 3: return launch<3, true, false>(VITERBI_ARGS);
    case 4: return launch<4, true, false>(VITERBI_ARGS);
    case 5: return launch<5, true, false>(VITERBI_ARGS);
    case 6: return launch<6, true, false>(VITERBI_ARGS);
    case 7: return launch<7, true, false>(VITERBI_ARGS);
    case 8: return launch<8, true, false>(VITERBI_ARGS);
    default: return launch<32, false, false>(VITERBI_ARGS);
  }
#undef VITERBI_ARGS
}
