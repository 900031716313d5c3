// Log-space Viterbi decoding of a dense-emission HMM, one warp a sequence.
//
// Counterpart of ngsepcore_tpu/kernels/hmm.py:85 (viterbi_log), which the
// JAX package writes as two lax.scan loops that XLA compiles into device
// loops; it has no Pallas kernel.  Semantics are those of
// kernels/hmm.py:viterbi_log_ref in this package:
//
//   delta[0][j]  = start[j] + emit[0][j]
//   back[t-1][j] = first i maximising delta[t-1][i] + trans[t-1][i][j]
//   delta[t][j]  = that maximum + emit[t][j]
//   path[T-1]    = first j maximising delta[T-1][j];  best = that maximum
//   path[t-1]    = back[t-1][path[t]]
//
// trans is (1, S, S), shared by every step, or (T-1, S, S).  Only f64
// additions and comparisons occur, so path and best equal the plain
// version's bit for bit; -inf entries behave as in IEEE arithmetic and a
// NaN never wins a comparison (the inputs must hold none).
//
// What bounds it: the recurrence is a serial chain over T (46,000 steps at
// 4.6 Mbp in 100 bp bins) of S <= 32 values; the bytes (T*S*9 + 4*T) are
// nothing beside it.  The design keeps the chain short and everything else
// off it: lane j owns state j and keeps delta[j] in a register; a step
// reads the previous deltas by shuffle, adds the transition column, and
// takes the first maximum of kCap >= S candidates (8 or 32, a template
// parameter; candidates from S up are -inf, which a strict '>' never
// takes) by a tree of pairwise compare-selects in which the left, smaller
// index keeps a tie: the same answer as a fold in ascending i, at a depth
// of log2(kCap) dependent selects.  The shuffles and additions of a step
// issue together.  Emissions are loaded one block of kAhead steps ahead
// into registers, a shared transition column sits in registers for the
// whole sequence, and a lane packs the block's kAhead back pointers into
// one 64-bit word (byte u = step u of the block) that leaves in one store
// nobody waits for.  The backtrace runs in the same launch: chunks of
// back-pointer words are copied to shared memory by the whole warp, lane 0
// walks their bytes there, and the warp writes the chunk of the path back
// coalesced.
//
// VITERBI_SKIP_BACKTRACE and VITERBI_SKIP_BACK_STORES take those parts out
// of the launch (the path is then not written): viterbi_bench.py builds
// with them to say where the time goes.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kMaxStates = 32;
constexpr int kAhead = 8;         // steps a block: emissions ahead, 8 back pointers a word
constexpr int kChunkBlocks = 16;  // blocks of back pointers per backtrace chunk
constexpr unsigned kFull = 0xffffffffu;
static_assert(kAhead == 8, "a block's back pointers fill the bytes of one 64-bit word");

template <int kCap, bool kPerStep>
__global__ void __launch_bounds__(32)
viterbi_kernel(const double* __restrict__ log_start,
               const double* __restrict__ log_trans,
               const double* __restrict__ log_emit, int T, int S,
               unsigned long long* back, int* __restrict__ path,
               double* __restrict__ best) {
  __shared__ unsigned long long back_s[kChunkBlocks * kMaxStates];
  __shared__ int path_s[kChunkBlocks * kAhead];
  const int lane = threadIdx.x;
  const bool live = lane < S;
  // idle lanes mirror the last state: they shuffle along and never store
  const int j = live ? lane : S - 1;
  const size_t seq = blockIdx.x;
  const size_t SS = (size_t)S * S;
  const int n_blocks = (T - 1 + kAhead - 1) / kAhead;
  const double* start = log_start + seq * S;
  const double* trans = log_trans + seq * (kPerStep ? (size_t)(T - 1) : 1) * SS;
  const double* emit = log_emit + seq * (size_t)T * S;
  unsigned long long* bk = back + seq * (size_t)n_blocks * S;
  int* out = path + seq * (size_t)T;

  // column j of the transitions, padded to kCap candidates with -inf
  double trc[kCap];
  if (!kPerStep) {
#pragma unroll
    for (int i = 0; i < kCap; ++i)
      trc[i] = i < S ? trans[(size_t)i * S + j] : -CUDART_INF;
  }
  double delta = start[j] + emit[j];

  double e_cur[kAhead], e_next[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    e_cur[u] = emit[(size_t)min(1 + u, T - 1) * S + j];
  for (int t0 = 1; t0 < T; t0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      e_next[u] = emit[(size_t)min(t0 + kAhead + u, T - 1) * S + j];
    unsigned long long packed = 0;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + u;
      if (t < T) {  // the same for every lane
        if (kPerStep) {
          const double* tr = trans + (size_t)(t - 1) * SS + j;
#pragma unroll
          for (int i = 0; i < kCap; ++i)
            trc[i] = i < S ? tr[(size_t)i * S] : -CUDART_INF;
        }
        double c[kCap];
        int arg[kCap];
#pragma unroll
        for (int i = 0; i < kCap; ++i) {
          c[i] = __shfl_sync(kFull, delta, i) + trc[i];
          arg[i] = i;
        }
        // c[i], arg[i] become the first maximum of candidates [i, i + 2w)
#pragma unroll
        for (int w = 1; w < kCap; w *= 2) {
#pragma unroll
          for (int i = 0; i < kCap; i += 2 * w) {
            if (c[i + w] > c[i]) {
              c[i] = c[i + w];
              arg[i] = arg[i + w];
            }
          }
        }
        delta = c[0] + e_cur[u];
        packed |= (unsigned long long)arg[0] << (8 * u);
      }
    }
#ifndef VITERBI_SKIP_BACK_STORES
    if (live) bk[(size_t)((t0 - 1) / kAhead) * S + lane] = packed;
#endif
#pragma unroll
    for (int u = 0; u < kAhead; ++u) e_cur[u] = e_next[u];
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

}  // namespace

// batch sequences of the same T and S, each with its own start, transition,
// emission, back-pointer scratch (ceil((T-1)/8), S) of 64-bit words, path (T)
// and best.
extern "C" int viterbi_launch(const void* log_start, const void* log_trans,
                              const void* log_emit, int batch, int T, int S,
                              int per_step, void* back, void* path, void* best,
                              void* stream) {
  if (batch <= 0 || T <= 0) return (int)cudaGetLastError();
  if (S < 1 || S > kMaxStates) return (int)cudaErrorInvalidValue;
  auto kernel = S <= 8 ? (per_step ? viterbi_kernel<8, true> : viterbi_kernel<8, false>)
                        : (per_step ? viterbi_kernel<kMaxStates, true>
                                    : viterbi_kernel<kMaxStates, false>);
  kernel<<<batch, 32, 0, (cudaStream_t)stream>>>(
      (const double*)log_start, (const double*)log_trans,
      (const double*)log_emit, T, S, (unsigned long long*)back, (int*)path,
      (double*)best);
  return (int)cudaGetLastError();
}
