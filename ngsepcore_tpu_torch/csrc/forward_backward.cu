// Log10-space forward-backward posteriors of dense-emission HMMs: one block
// for a few samples, every sample of an imputation E-step in one launch.
//
// Counterpart of ngsepcore_tpu/kernels/hmm.py:33 (forward_log), :57
// (backward_log) and :75 (posterior_log), lax.scan loops that the JAX
// imputer vmaps over samples (imputation/genotype_imputer.py:146); the JAX
// package has no Pallas kernel for them.  Semantics are those of
// kernels/hmm.py:posterior_log_batch_ref in this package, for each sample b:
//
//   alpha[0][j]  = start[j] + emit[0][j]
//   alpha[t][j]  = lse_i(alpha[t-1][i] + trans[t-1][i][j]) + emit[t][j]
//   ll           = lse_j(alpha[T-1][j])
//   beta[T-1][i] = 0
//   beta[t][i]   = lse_j(trans[t][i][j] + (emit[t+1][j] + beta[t+1][j]))
//   post[t][s]   = un[t][s] - lse_s(un[t][s]),   un = alpha + beta
//
// with lse(x) = m + log10(sum 10^(x - m)), m the maximum, and lse(x) = m
// where m is not finite (the JAX package's _log10sumexp guard).  The sums
// are taken in one fixed order:
//  - a row sum (over i in the forward pass, over j in the backward pass) in
//    four partial sums, row r into sum r mod 4 in ascending r, then
//    (s0 + s1) + (s2 + s3);
//  - a sum over a sample's states (ll, the posterior's norm) first over each
//    warp's lanes by a shfl_down tree (offsets 16, 8, 4, 2, 1; lanes past S
//    add 0) and then the warps' sums in ascending warp order.
// Maxima are exact in any order.  exp10 and log10 are CUDA's f64 functions,
// so the results agree with the plain version (torch.pow, torch.log10) to
// rounding, not bit for bit; tests/test_torch_hmm.py holds a torch model of
// this order against the plain loop.
//
// Layout: start (S,); trans (1, S, S) shared by every step or (T-1, S, S);
// emit (n, T, S); post (n, T, S), which is also alpha's scratch: the forward
// pass writes alpha[t] into post[t], the backward pass replaces it by the
// posterior as beta reaches t; ll (n,).
//
// Work: every step of each pass evaluates S x S terms with one exp10 each
// (2 n T S^2 exp10 an E-step: 12.3 G at the imputer's n 300, T 5,000, S 64),
// far more than the function needs: the transitions are shared by every
// sample, so a step could be an (n x S) x (S x S) product of scaled
// probabilities with S exp10 a sample (chip_smoke.fb_bound's floor, PERF.md).
// The design is the simple one:
//  - thread j of a sample owns destination state j; the previous step's S
//    values sit in shared memory (two buffers by parity, so one barrier a
//    step) and every thread reads them as broadcasts;
//  - the step's transition matrix is staged in shared memory by the whole
//    block, so the samples of a block share it, in chunks of rows where it
//    does not fit (beyond S 109 at one sample a block); the backward pass
//    stages it transposed, so both passes read a tile row across the
//    threads and no thread makes strided global loads.  Rows are S + 1
//    doubles apart, which spreads the transposed writes over the banks.  A
//    matrix shared by every step and held in one chunk is staged once a
//    pass;
//  - each thread keeps four partial maxima and sums (the order above), four
//    independent chains of compare-selects, exp10s and adds.
// Measured (PERF.md), a step waits on its barriers and on the staging of
// the tile.  Several samples a block (four at S 64 by default:
// kernels/hmm.py FB_BLOCK_THREADS) share both and give the SM more warps to
// switch between.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxStates = 1024;
constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSmem = 96 * 1024;  // dynamic shared memory a block may take
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double sel_max(double a, double b) { return b > a ? b : a; }

// rows [r0, r0 + nr) of M into the tile (row stride ld): M = tr or, for the
// backward pass, its transpose (M[r][c] = tr[c][r])
__device__ __forceinline__ void load_chunk(double* tile, const double* __restrict__ tr, int S,
                                           int ld, int r0, int nr, bool transpose) {
  const int nt = blockDim.x;
  if (!transpose) {
#pragma unroll 4
    for (int k = threadIdx.x; k < nr * S; k += nt) {
      const int r = k / S, c = k - r * S;
      tile[r * ld + c] = tr[(size_t)(r0 + r) * S + c];
    }
  } else {
    // column c of the chunk is the contiguous run tr[c][r0 .. r0 + nr)
#pragma unroll 4
    for (int k = threadIdx.x; k < nr * S; k += nt) {
      const int c = k / nr, r = k - c * nr;
      tile[r * ld + c] = tr[(size_t)c * S + r0 + r];
    }
  }
}

// the four partial maxima of v[r] + M[r][c] over the nr rows of a chunk
// whose first row r0 is a multiple of 4 (row r goes to maximum r mod 4)
__device__ __forceinline__ void chunk_max(const double* tile, const double* v, int ld, int r0,
                                          int nr, int c, double (&m)[4]) {
  int r = 0;
  for (; r + 4 <= nr; r += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = sel_max(m[k], v[r0 + r + k] + tile[(r + k) * ld + c]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (r + k < nr) m[k] = sel_max(m[k], v[r0 + r + k] + tile[(r + k) * ld + c]);
}

// the four partial sums of 10^(v[r] + M[r][c] - ms), in ascending r
__device__ __forceinline__ void chunk_sum(const double* tile, const double* v, int ld, int r0,
                                          int nr, int c, double ms, double (&s)[4]) {
  int r = 0;
  for (; r + 4 <= nr; r += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] += exp10((v[r0 + r + k] + tile[(r + k) * ld + c]) - ms);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (r + k < nr) s[k] += exp10((v[r0 + r + k] + tile[(r + k) * ld + c]) - ms);
}

// lse_r(v[r] + M[r][c]) for every column c that a live thread owns.  Every
// thread of the block calls it; it begins with a barrier (v written, the
// tile's last readers done) and stages M unless the tile already holds it.
__device__ __forceinline__ double row_lse(double* tile, const double* v,
                                          const double* __restrict__ tr, int S, int ld, int rows,
                                          bool staged, bool transpose, int c, bool live) {
  const int chunks = (S + rows - 1) / rows;
  double m[4] = {-CUDART_INF, -CUDART_INF, -CUDART_INF, -CUDART_INF};
  __syncthreads();
  for (int k = 0; k < chunks; ++k) {
    const int r0 = k * rows, nr = min(rows, S - r0);
    if (!staged) {
      if (k > 0) __syncthreads();
      load_chunk(tile, tr, S, ld, r0, nr, transpose);
      __syncthreads();
    }
    if (live) chunk_max(tile, v, ld, r0, nr, c, m);
  }
  const double mx = sel_max(sel_max(m[0], m[1]), sel_max(m[2], m[3]));
  const double ms = isfinite(mx) ? mx : 0.0;
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  if (chunks == 1) {
    if (live) chunk_sum(tile, v, ld, 0, S, c, ms, s);
  } else {
    for (int k = 0; k < chunks; ++k) {
      const int r0 = k * rows, nr = min(rows, S - r0);
      __syncthreads();
      load_chunk(tile, tr, S, ld, r0, nr, transpose);
      __syncthreads();
      if (live) chunk_sum(tile, v, ld, r0, nr, c, ms, s);
    }
  }
  const double sum = (s[0] + s[1]) + (s[2] + s[3]);
  return isfinite(mx) ? ms + log10(sum) : mx;
}

// maximum and sum over the warps [w0, w0 + wps) of one sample (red: one
// double a warp of the block); every thread of the block calls them
__device__ __forceinline__ double group_max(double x, double* red, int w0, int wps) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = sel_max(x, __shfl_xor_sync(kFull, x, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double y = red[w0];
  for (int w = 1; w < wps; ++w) y = sel_max(y, red[w0 + w]);
  __syncthreads();
  return y;
}

__device__ __forceinline__ double group_sum(double x, double* red, int w0, int wps) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double y = red[w0];
  for (int w = 1; w < wps; ++w) y += red[w0 + w];
  __syncthreads();
  return y;
}

// lse over a sample's states: x of each live thread
__device__ __forceinline__ double group_lse(double x, bool live, double* red, int w0, int wps) {
  const double mx = group_max(live ? x : -CUDART_INF, red, w0, wps);
  const double ms = isfinite(mx) ? mx : 0.0;
  const double sum = group_sum(live ? exp10(x - ms) : 0.0, red, w0, wps);
  return isfinite(mx) ? ms + log10(sum) : mx;
}

// grid: ceil(n / G) blocks of G x ns threads (ns: S rounded up to a warp);
// thread g * ns + c owns state c of sample blockIdx.x * G + g
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
forward_backward_kernel(const double* __restrict__ start, const double* __restrict__ trans,
                        const double* __restrict__ emit, int n, int T, int S, int per_step,
                        int G, int ns, int rows, double* __restrict__ post,
                        double* __restrict__ ll) {
  extern __shared__ double smem[];
  const int ld = S + 1;
  const int g = threadIdx.x / ns;
  const int c = threadIdx.x - g * ns;
  const int b = blockIdx.x * G + g;
  const bool live = c < S && b < n;
  const int wps = ns / 32, w0 = g * wps;
  double* tile = smem;
  double* v0 = tile + (size_t)rows * ld + g * S;  // two buffers by parity, G * S apart
  double* red = tile + (size_t)rows * ld + 2 * G * S;
  const int vpar = G * S;
  const size_t SS = (size_t)S * S;
  const double* e = emit + (size_t)(b < n ? b : 0) * T * S;
  double* p = post + (size_t)(b < n ? b : 0) * T * S;
  // a matrix shared by every step, held in one chunk, is staged once a pass
  const bool staged = !per_step && rows == S;

  // forward: alpha[t] into post[t] and into the parity buffer of step t
  double a = live ? start[c] + e[c] : 0.0;
  if (live) {
    p[c] = a;
    v0[c] = a;
  }
  if (staged) load_chunk(tile, trans, S, ld, 0, S, false);
  for (int t = 1; t < T; ++t) {
    const double et = live ? e[(size_t)t * S + c] : 0.0;
    const double* tr = trans + (per_step ? (size_t)(t - 1) * SS : 0);
    a = row_lse(tile, v0 + ((t - 1) & 1) * vpar, tr, S, ld, rows, staged, false, c, live) + et;
    if (live) {
      p[(size_t)t * S + c] = a;
      v0[(t & 1) * vpar + c] = a;
    }
  }
  const double lik = group_lse(a, live, red, w0, wps);
  if (live && c == 0) ll[b] = lik;

  // backward: beta[t] in a register, the posterior into post[t]
  if (staged) load_chunk(tile, trans, S, ld, 0, S, true);  // the barriers above kept the tile
  double be = 0.0;
  {
    const double un = a + be;
    const double norm = group_lse(un, live, red, w0, wps);
    if (live) p[(size_t)(T - 1) * S + c] = un - norm;
  }
  for (int t = T - 2; t >= 0; --t) {
    if (live) v0[(t & 1) * vpar + c] = e[(size_t)(t + 1) * S + c] + be;
    const double al = live ? p[(size_t)t * S + c] : 0.0;
    const double* tr = trans + (per_step ? (size_t)t * SS : 0);
    be = row_lse(tile, v0 + (t & 1) * vpar, tr, S, ld, rows, staged, true, c, live);
    const double un = al + be;
    const double norm = group_lse(un, live, red, w0, wps);
    if (live) p[(size_t)t * S + c] = un - norm;
  }
}

template <int kThreads>
int launch(const double* start, const double* trans, const double* emit, int n, int T, int S,
           int per_step, int G, int ns, int rows, size_t smem, double* post, double* ll,
           cudaStream_t stream) {
  // the dynamic shared-memory limit is an attribute of the current device:
  // set it at every launch (a host-side call), so that every device has it
  const cudaError_t rc = cudaFuncSetAttribute(forward_backward_kernel<kThreads>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)kMaxSmem);
  if (rc != cudaSuccess) return (int)rc;
  forward_backward_kernel<kThreads><<<(n + G - 1) / G, G * ns, smem, stream>>>(
      start, trans, emit, n, T, S, per_step, G, ns, rows, post, ll);
  return (int)cudaGetLastError();
}

}  // namespace

// start (S,), trans (1 | T-1, S, S) (per_step: T-1 matrices), emit (n, T, S),
// all f64 and contiguous; writes post (n, T, S) and ll (n,).  G samples a
// block (G x ceil(S/32) x 32 <= 1,024 threads).
extern "C" int forward_backward_launch(const void* start, const void* trans, const void* emit,
                                       int n, int T, int S, int per_step, int G, void* post,
                                       void* ll, void* stream) {
  if (n <= 0 || T <= 0) return (int)cudaGetLastError();
  if (S < 1 || S > kMaxStates || G < 1) return (int)cudaErrorInvalidValue;
  const int ns = (S + 31) / 32 * 32;
  if (G * ns > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t ld = (size_t)S + 1;
  const size_t fixed = sizeof(double) * (2 * (size_t)G * S + (size_t)G * ns / 32);
  int rows = S;
  if ((size_t)S * ld * sizeof(double) + fixed > kMaxSmem) {
    // chunks of a multiple of 4 rows, so that row r0 + r goes to sum r mod 4
    rows = (int)((kMaxSmem - fixed) / (ld * sizeof(double))) & ~3;
    if (rows < 4) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)rows * ld * sizeof(double) + fixed;
  const double* s = (const double*)start;
  const double* tr = (const double*)trans;
  const double* e = (const double*)emit;
  double* po = (double*)post;
  double* l = (double*)ll;
  const cudaStream_t st = (cudaStream_t)stream;
  if (G * ns <= 256) return launch<256>(s, tr, e, n, T, S, per_step, G, ns, rows, smem, po, l, st);
  return launch<1024>(s, tr, e, n, T, S, per_step, G, ns, rows, smem, po, l, st);
}
