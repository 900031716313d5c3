// Log10 forward-backward posteriors of dense-emission HMMs: every sample of
// an imputation E-step in one launch, in one of two forms.
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
// where m is not finite (the JAX package's _log10sumexp guard).
//
// Layout: start (S,); trans (1, S, S) shared by every step or (T-1, S, S);
// emit (n, T, S); post (n, T, S), which is also alpha's scratch; ll (n,).
//
// THE PRODUCT FORM (fb_prepare_kernel, fb_product_kernel, then
// fb_posterior_kernel).  Every sample of a step shares its transition
// matrix, so where the values stay in range the recursion runs on scaled
// linear probabilities, each step one (samples x S) x (S x S) f64 product
// on the tensor cores:
//   P[t]  = 10^(trans[t] - gmax[t]), gmax[t] the matrix's maximum;
//   E^    = 10^(emit[b][t][c] - emit[b][t][0]);
//   a^[0] = 10^(start + emit[b][0] - (start[0] + emit[b][0][0]));
//   a^[t] = ((a^[t-1] @ P[t-1]) * 2^-k) * E^[t],  2^k the power of two of
//           a^[t-1][0] (exact to multiply by);
//   ll    = (L + K log10 2) + log10(sum_c a^[T-1][c]), L the sum of the
//           log10 offsets (start[0] + emit[b][0][0], then gmax[t-1] +
//           emit[b][t][0] a step), K the sum of the k;
//   b^[T-1] = 1;  z[t] = b^[t] * E^[t];
//   b^[t] = (z[t+1] @ P[t]^T) * 2^-k,  2^k the power of two of z[t+1][0];
//   post[t][c] = log10(u[c]) - log10(sum_c u[c]),  u = a^[t] b^[t] (the
//           per-step scales cancel).
// The range that keeps every value a normal f64.  Write R_M for the largest
// spread (max - min) of one step's matrix, R_S for the start's, R_E for the
// largest spread of one sample-step's emissions, and R = max(R_M, R_S).
// A ratio of two positive sums is at most the largest ratio of their terms,
// so a^[t][c] / a^[t][0] <= 10^(R_M + R_E) (and >= its inverse), and after
// the scale 1 <= a'[0] < 2, a'[r] <= 2 10^(R_M + R_E).  With P in
// [10^-R_M, 1] and E^ in [10^-R_E, 10^R_E] (E^[0] = 1):
//   a^[t]      in [10^-(R_M + R_E), 2 S 10^(R_M + 2 R_E)]   (t >= 1; a^[0]
//              in 10^+-(R_S + R_E));
//   b^[t]      in [10^-R_M, 2 S 10^(R_M + R_E)];
//   a^ b^      in [10^-(2 R + R_E), 4 S^2 10^(2 R + 3 R_E)];
//   a term a'[r] P[r][c] of a product >= 10^-(2 R_M + R_E).
// So with 2 R + 3 R_E <= 250 (kernels/hmm.py PRODUCT_RANGE) and S <= 64
// every value lies in [10^-250, 10^255]: normal both ways (2.2e-308 to
// 1.8e308), with no subnormal term in any sum, so each step rounds as a
// sum of positive terms does (a few ulps).  Every start, transition and
// emission entry must also be finite.  fb_prepare_kernel measures R_M, R_E
// and R_S (one pass over the inputs, one host read); kernels/hmm.py routes an
// input that meets the bound to this form and any other to the log form,
// whose answers are the same function: this is a route by a property of
// the input, not a fallback.
// Design (S <= 64, a block of 8 or 16 samples and Sp / 8 warps, Sp = S
// rounded up to 8), shaped by what fb_bench.py measured on the H100:
//  - the prologue, one pass over the inputs on every SM, writes P (zeros
//    past S) in the order the lanes read it, gmax, and E^ into an (n, T, S)
//    scratch: no exp10 in a step (in a step, exp10 and log10 chains were
//    most of its latency);
//  - warp w owns columns [8w, 8w + 8) of every row: its n8 tile of each
//    m8n8k4 DMMA (mma.sync f64), lane (g, q) = (lane / 4, lane % 4) row g
//    of each m-tile and columns 8w + 2q, 8w + 2q + 1; the k-steps go round
//    four accumulators, summed (acc0 + acc1) + (acc2 + acc3).  m8n8k4 runs
//    at half the FP64 tensor rate (16 cycles an instruction of a
//    sub-partition, as m16n8k4, which does twice the work), so 8 samples
//    cost 512 cycles a step of the tensor pipe;
//  - the step's input rows (a^ or z) sit in shared memory by parity (one
//    barrier a step); A fragments read row g (rows Sp + 4 doubles apart: no
//    bank conflict); B fragments come from the global scratch into
//    registers, two steps ahead, 16 bytes a lane, a warp's 512 contiguous
//    bytes a load (staging P through shared memory, by TMA or cp.async,
//    measured no faster); the backward pass reads P^T's fragments;
//  - the E^ rows (and in the backward pass the a^ rows) and the offsets go
//    through a ring of kStages steps in shared memory by cp.async;
//  - the scale reads column 0 of the input row, so no reduction is on a
//    step's chain; the forward pass writes a^[t] into post[t], the
//    backward pass u = a^[t] b^[t] over it, and fb_posterior_kernel (a row
//    a warp, on every SM) turns u into posteriors: no log10 in a step.
//
// THE LOG FORM (forward_backward_kernel): every cell in log10 space, for
// any input.  The sums are taken in one fixed order:
//  - a row sum (over i in the forward pass, over j in the backward pass) in
//    four partial sums, row r into sum r mod 4 in ascending r, then
//    (s0 + s1) + (s2 + s3);
//  - a sum over a sample's states (ll, the posterior's norm) first over each
//    warp's lanes by a shfl_down tree (offsets 16, 8, 4, 2, 1; lanes past S
//    add 0) and then the warps' sums in ascending warp order.
// Maxima are exact in any order.  exp10 and log10 are CUDA's f64 functions,
// so the results of either form agree with the plain version (torch.pow,
// torch.log10) to rounding, not bit for bit; tests/test_torch_hmm.py holds a
// torch model of each form's order against the plain loop.
// Work: every step of each pass evaluates S x S terms with one exp10 each
// (2 n T S^2 exp10 an E-step: 12.3 G at the imputer's n 300, T 5,000, S 64).
// Design:
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
// the tile.  ptxas keeps a few loop invariants on the stack (60 bytes of
// spill stores at 256 threads, 156 at 1,024): the S x S stride and the
// divisions' constants of load_chunk's k / S and k / nr, stored at the
// kernel's start and before the backward pass and reloaded where each
// pass stages a tile (fb_bench.py lists the STL / LDL in the SASS).  Several samples a block (four at S 64 by default:
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


// ---------------------------------------------------------------------------
// The product form.

constexpr int kProductMaxStates = 64;  // one step's P, padded, in each ring stage
constexpr int kPrepThreads = 256;
constexpr double kLog10Two = 0.30102999566398119521;

// the bits of a non-negative double order as the double: an atomicMax of them
__device__ __forceinline__ unsigned long long spread_bits(double mx, double mn, bool bad) {
  return (unsigned long long)__double_as_longlong(bad ? CUDART_INF : mx - mn);
}

// maximum, minimum and "an entry is not finite" over the block (every
// thread calls it; red holds 2 x 32 doubles)
__device__ __forceinline__ void block_range(double& mx, double& mn, bool& bad, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmax(mx, __shfl_xor_sync(kFull, mx, o));
    mn = fmin(mn, __shfl_xor_sync(kFull, mn, o));
  }
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[w] = mx;
    red[32 + w] = mn;
  }
  bad = __syncthreads_or(bad);
  mx = red[0];
  mn = red[32];
  for (int k = 1; k < nw; ++k) {
    mx = fmax(mx, red[k]);
    mn = fmin(mn, red[32 + k]);
  }
  __syncthreads();
}

// The prologue, one pass over the inputs: P = 10^(trans[m] - gmax[m]) of
// every matrix m, zeros past S, into the (nM, 2, Sp, Sp) scratch in the
// order the product kernel's lanes read their B fragments (frag_index: the
// forward pass's P, then the backward pass's P^T), and gmax[m]; E^ =
// 10^(emit[b][t][c] - emit[b][t][0]) of every emission into the (n, T, S)
// scratch Eh; and the three spreads of the route into stats (R_M, R_E, R_S
// as the bits of non-negative doubles, +inf where an entry is not finite;
// the wrapper zeroes them).  Blocks take matrices, then warps take emission
// rows (a row a warp, S <= 64), then block 0 takes the start.
__global__ void __launch_bounds__(kPrepThreads)
fb_prepare_kernel(const double* __restrict__ start, const double* __restrict__ trans,
                  const double* __restrict__ emit, int n, int T, int S, int nM,
                  double* __restrict__ P, double* __restrict__ gmax, double* __restrict__ Eh,
                  unsigned long long* __restrict__ stats) {
  __shared__ double red[64];
  const int Sp = (S + 7) / 8 * 8;
  const int lane = threadIdx.x & 31;
  unsigned long long rm = 0, re = 0;
  for (int m = blockIdx.x; m < nM; m += gridDim.x) {
    const double* M = trans + (size_t)m * S * S;
    double mx = -CUDART_INF, mn = CUDART_INF;
    bool bad = false;
    for (int k = threadIdx.x; k < S * S; k += blockDim.x) {
      const double x = M[k];
      bad |= !isfinite(x);
      mx = fmax(mx, x);
      mn = fmin(mn, x);
    }
    block_range(mx, mn, bad, red);
    if (threadIdx.x == 0) {
      rm = max(rm, spread_bits(mx, mn, bad));
      gmax[m] = mx;
    }
    double* Pm = P + (size_t)m * 2 * Sp * Sp;
    for (int k = threadIdx.x; k < Sp * Sp; k += blockDim.x) {
      // k = ((w H + h) 32 + l) 2 + i: warp w's lane l, its k-step 2h + i
      const int H = Sp / 8, i = k & 1, l = (k >> 1) & 31, wh = k >> 6;
      const int r = 4 * (2 * (wh % H) + i) + (l & 3), c = 8 * (wh / H) + (l >> 2);
      const bool in = r < S && c < S && !bad;
      Pm[k] = in ? exp10(M[r * S + c] - mx) : 0.0;                          // P[r][c]
      Pm[Sp * Sp + k] = in ? exp10(M[c * S + r] - mx) : 0.0;  // P[c][r]
    }
  }
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (long long row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); row < (long long)n * T;
       row += warps) {
    const double* e = emit + row * S;
    const double x0 = lane < S ? e[lane] : 0.0, x1 = lane + 32 < S ? e[lane + 32] : 0.0;
    const double ref = __shfl_sync(kFull, x0, 0);
    double mx = fmax(x0, lane + 32 < S ? x1 : -CUDART_INF);
    double mn = fmin(x0, lane + 32 < S ? x1 : CUDART_INF);
    if (lane >= S) {
      mx = -CUDART_INF;
      mn = CUDART_INF;
    }
    bool bad = (lane < S && !isfinite(x0)) || (lane + 32 < S && !isfinite(x1));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmax(mx, __shfl_xor_sync(kFull, mx, o));
      mn = fmin(mn, __shfl_xor_sync(kFull, mn, o));
    }
    bad = __any_sync(kFull, bad);
    re = max(re, spread_bits(mx, mn, bad));
    double* h = Eh + row * S;
    if (lane < S) h[lane] = exp10(x0 - ref);
    if (lane + 32 < S) h[lane + 32] = exp10(x1 - ref);
  }
  if (lane == 0 && re) atomicMax(stats + 1, re);
  if (threadIdx.x == 0 && rm) atomicMax(stats, rm);
  if (blockIdx.x == 0) {
    double mx = -CUDART_INF, mn = CUDART_INF;
    bool bad = false;
    for (int c = threadIdx.x; c < S; c += blockDim.x) {
      bad |= !isfinite(start[c]);
      mx = fmax(mx, start[c]);
      mn = fmin(mn, start[c]);
    }
    block_range(mx, mn, bad, red);
    if (threadIdx.x == 0) atomicMax(stats + 2, spread_bits(mx, mn, bad));
  }
}

__device__ __forceinline__ void cp_async16(double* smem, const double* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
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

// d += a b over one m8n8k4 tile: a row g, column q of A; b row q, column g
// of B; d row g, columns 2q, 2q + 1 (g = lane / 4, q = lane % 4)
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// 2^-k for the power of two 2^k of a positive normal x (its exponent field)
__device__ __forceinline__ double inverse_power_of_two(double x, int& k) {
  const int biased = (int)((unsigned long long)__double_as_longlong(x) >> 52) & 0x7ff;
  k = biased - 1023;
  return __longlong_as_double((long long)(2046 - biased) << 52);
}

// The ring of the product kernel: a stage holds what one step reads beside
// its input rows and its B fragments: the E^ rows of the block's G samples
// and, in the backward pass, their a^ rows (le = Sp + 8 apart, so that a
// lane's 16-byte read of its two columns has no bank conflict), then G
// emission offsets emit[b][t][0] and the step's gmax.
template <int kSp, int kG>
struct Stage {
  static constexpr int kLe = kSp + 8;
  static constexpr int kE = 0, kA = kG * kLe, kE0 = kA + kG * kLe, kGmax = kE0 + kG;
  static constexpr int kDoubles = (kGmax + 2) / 2 * 2;  // 16-byte aligned stages
};

// the products of one step for kMT m-tiles: y[m] = rows of X times the
// warp's n8 tile of the step's matrix, whose B fragments the lane holds (k-
// step kk in bf[kk / 2]: .x for even kk); k-step kk into accumulator kk mod
// 4, then (acc0 + acc1) + (acc2 + acc3)
template <int kMT, int kSp>
__device__ __forceinline__ void step_products(const double* X, const double2 (&bf)[kSp / 8],
                                              int g, int q, double (&y)[kMT][2]) {
  constexpr int kLd = kSp + 4;
#ifdef FB_ABLATE_PRODUCTS
  // ablation: no products, each row's column 0 stands for every column
#pragma unroll
  for (int m = 0; m < kMT; ++m) y[m][0] = y[m][1] = X[(8 * m + g) * kLd] + 0.0 * bf[0].x;
#else
  double acc[kMT][4][2];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j][0] = acc[m][j][1] = 0.0;
  // every A fragment first, so that no DMMA waits on a shared-memory load
  double af[kMT][kSp / 4];
#pragma unroll
  for (int kk = 0; kk < kSp / 4; ++kk)
#pragma unroll
    for (int m = 0; m < kMT; ++m) af[m][kk] = X[(8 * m + g) * kLd + 4 * kk + q];
#pragma unroll
  for (int kk = 0; kk < kSp / 4; ++kk)
#pragma unroll
    for (int m = 0; m < kMT; ++m)
      dmma(acc[m][kk & 3], af[m][kk], (kk & 1) ? bf[kk / 2].y : bf[kk / 2].x);
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      y[m][i] = (acc[m][0][i] + acc[m][1][i]) + (acc[m][2][i] + acc[m][3][i]);
#endif
}

// the sum of the four lanes of a row group: (x0 + x1) + (x2 + x3) in each
__device__ __forceinline__ double group_row_sum(double x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

#ifdef FB_ABLATE_STORES
constexpr bool kStores = false;  // ablation: the steps store no a^ and no u
#else
constexpr bool kStores = true;
#endif

#ifdef FB_ABLATE_EXCHANGE
// ablation: no exchange from step to step: every step reads the same input
// rows (buffer 0, never rewritten), so no step waits on the one before; the
// barrier stays, for the ring
constexpr int kExchange = 0;
#else
constexpr int kExchange = 1;
#endif

// The recursions.  grid: ceil(n / G) blocks of Sp / 8 warps, G = 8 kMT
// samples a block.  The forward pass writes a^[t] into post[t]; the
// backward pass reads it back (through the ring) and writes u = a^ b^ over
// it, which fb_posterior_kernel then normalises.
template <int kMT, int kSp, int kStages>
__global__ void __launch_bounds__(256, 1)
fb_product_kernel(const double* __restrict__ start, const double* __restrict__ P,
                  const double* __restrict__ gmax, const double* __restrict__ Eh,
                  const double* __restrict__ emit, int n, int T, int S, int per_step,
                  double* __restrict__ post, double* __restrict__ ll) {
  extern __shared__ __align__(16) double fb_smem[];
  constexpr int G = 8 * kMT, W = kSp / 8, H = kSp / 8, kLd = kSp + 4;
  using St = Stage<kSp, G>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = 8 * warp + 2 * q;              // this lane's columns: c0, c0 + 1
  double* ring = fb_smem;                       // kStages stages
  double* X = ring + kStages * St::kDoubles;    // 2 x G x kLd, by parity
  double* psum = X + 2 * G * kLd;               // W x G
  const bool col[2] = {c0 < S, c0 + 1 < S};
#ifdef FB_ABLATE_DELIVERY
  per_step = 0;  // ablation: every step reads the first matrix, loaded once
#endif
  const int steps = T - 1;
  const size_t TS = (size_t)T * S;
  // row r of the block is sample b0 + r; a row past n computes sample n - 1,
  // unwritten
  const int b0 = blockIdx.x * G;
  auto row_of = [&](const double* base, int r) {
    return base + (size_t)min(b0 + r, n - 1) * TS;
  };
  bool live[kMT];
  double* p[kMT];
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    live[m] = b0 + 8 * m + g < n;
    p[m] = post + (size_t)min(b0 + 8 * m + g, n - 1) * TS;
  }
  // The lane's B fragments of matrix `mat` in direction dir (0: P, forward;
  // 1: P^T, backward): H 16-byte loads, each a warp's 512 contiguous bytes.
  auto load_frags = [&](double2 (&bf)[H], int mat, int dir) {
    const double2* src = reinterpret_cast<const double2*>(P + (2 * (size_t)mat + dir) * kSp * kSp) +
                         warp * H * 32 + lane;
#pragma unroll
    for (int h = 0; h < H; ++h) bf[h] = src[h * 32];
  };
  // The stage of step t of a pass into ring slot `slot`: the E^ rows of t,
  // and e0 and gmax (forward) or the a^ rows of t (backward).  By cp.async a
  // thread copies the same chunks every step: 16 bytes of rows r0 + 8m at
  // column cp (m < kMT), and the offset of row tid (tid < G) or gmax (tid ==
  // G).
  const int r0 = threadIdx.x / (kSp / 2), cp = 2 * (threadIdx.x % (kSp / 2));
  const double* erow = emit + (size_t)min(b0 + (int)threadIdx.x, n - 1) * TS;
  auto stage = [&](int slot, int mat, int t, bool forward) {
    double* st = ring + slot * St::kDoubles;
#ifndef FB_ABLATE_ROWS  // ablation: no E^ or a^ rows and no offsets staged
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i == 1 && forward) break;
      const double* base = i == 0 ? Eh : post;
      double* d = st + (i == 0 ? St::kE : St::kA);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const double* src = row_of(base, r0 + 8 * m) + (size_t)t * S + cp;
        double* dst = d + (r0 + 8 * m) * St::kLe + cp;
        if (S == kSp) {
          cp_async16(dst, src);
        } else {  // rows of S doubles need not be 16-byte aligned
          if (cp < S) cp_async8(dst, src);
          if (cp + 1 < S) cp_async8(dst + 1, src + 1);
        }
      }
    }
    if (forward) {
      if (threadIdx.x < G) cp_async8(st + St::kE0 + threadIdx.x, erow + (size_t)t * S);
      if (threadIdx.x == G) cp_async8(st + St::kGmax, gmax + mat);
    }
#endif
  };
  double2 bfa[H], bfb[H];  // B fragments of even and odd steps

  // ---- forward: a^[t] into post[t] (linear, scaled) ----
  double a[kMT][2], L[kMT];
  int K[kMT];
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const double* e = row_of(emit, 8 * m + g);
    const double ref = start[0] + e[0];
    L[m] = ref;
    K[m] = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = c0 + i;
      a[m][i] = col[i] ? exp10((start[c] + e[c]) - ref) : 0.0;
      X[(8 * m + g) * kLd + c] = a[m][i];
      if (live[m] && col[i]) p[m][c] = a[m][i];
    }
  }
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < steps) stage(j, per_step ? j : 0, j + 1, true);
    cp_async_commit();
  }
  if (steps > 0) load_frags(bfa, 0, 0);
  if (steps > 1) load_frags(bfb, per_step ? 1 : 0, 0);
  // step j of the pass (t = j + 1) with its B fragments bf, which it then
  // refills for step j + 2
  auto forward_step = [&](int j, double2 (&bf)[H]) {
    const int t = j + 1;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const double* st = ring + (j % kStages) * St::kDoubles;
    const double* Xin = X + kExchange * (j & 1) * G * kLd;
    double* Xout = X + (kExchange ? (j + 1) & 1 : 1) * G * kLd;
    double s[kMT];
    int k[kMT];
#pragma unroll
    for (int m = 0; m < kMT; ++m) s[m] = inverse_power_of_two(Xin[(8 * m + g) * kLd], k[m]);
    double y[kMT][2];
    step_products<kMT, kSp>(Xin, bf, g, q, y);
    if (per_step && j + 2 < steps) load_frags(bf, j + 2, 0);
    {
      const int jn = j + kStages - 1;
      if (jn < steps) stage(jn % kStages, per_step ? jn : 0, jn + 1, true);
      cp_async_commit();
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const double2 E = *reinterpret_cast<const double2*>(st + St::kE + (8 * m + g) * St::kLe + c0);
      a[m][0] = (y[m][0] * s[m]) * E.x;
      a[m][1] = (y[m][1] * s[m]) * E.y;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        Xout[(8 * m + g) * kLd + c0 + i] = col[i] ? a[m][i] : 0.0;
        if (live[m] && col[i] && kStores) p[m][(size_t)t * S + c0 + i] = a[m][i];
      }
      L[m] += st[St::kGmax] + st[St::kE0 + 8 * m + g];
      K[m] += k[m];
    }
  };
  for (int j = 0; j < steps; j += 2) {
    forward_step(j, bfa);
    if (j + 1 < steps) forward_step(j + 1, bfb);
  }
  cp_async_wait<0>();
  // ll: the row sums of a^[T-1] over the warps in ascending order
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const double r = group_row_sum((col[0] ? a[m][0] : 0.0) + (col[1] ? a[m][1] : 0.0));
    if (q == 0) psum[warp * G + 8 * m + g] = r;
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    double tot = psum[8 * m + g];
    for (int w = 1; w < W; ++w) tot += psum[w * G + 8 * m + g];
    const int b = blockIdx.x * G + 8 * m + g;
    // mul then add, never contracted into an fma (the same in every build)
    if (live[m] && warp == 0 && q == 0)
      ll[b] = __dadd_rn(__dadd_rn(L[m], __dmul_rn(K[m], kLog10Two)), log10(tot));
  }
#ifdef FB_ABLATE_BACKWARD
  return;  // ablation: the forward pass and ll alone
#endif
  __syncthreads();  // the ring and X are free again; post[t] written

  // ---- backward: z[t] through shared memory, u = a^ b^ into post[t] ----
  // b^[T-1] = 1, so z[T-1] = E^[T-1] and u[T-1] = a^[T-1], already in post
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      X[(8 * m + g) * kLd + c0 + i] = col[i] ? row_of(Eh, 8 * m + g)[(size_t)(T - 1) * S + c0 + i] : 0.0;
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < steps) stage(j, 0, steps - 1 - j, false);
    cp_async_commit();
  }
  if (steps > 0) load_frags(bfa, per_step ? steps - 1 : 0, 1);
  if (steps > 1) load_frags(bfb, per_step ? steps - 2 : 0, 1);
  // step j of the pass (t = T - 2 - j) with its B fragments bf, which it
  // then refills for step j + 2
  auto backward_step = [&](int j, double2 (&bf)[H]) {
    const int t = T - 2 - j;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const double* st = ring + (j % kStages) * St::kDoubles;
    const double* Xin = X + kExchange * (j & 1) * G * kLd;
    double* Xout = X + (kExchange ? (j + 1) & 1 : 1) * G * kLd;
    double s[kMT];
    int k[kMT];
#pragma unroll
    for (int m = 0; m < kMT; ++m) s[m] = inverse_power_of_two(Xin[(8 * m + g) * kLd], k[m]);
    double y[kMT][2];
    step_products<kMT, kSp>(Xin, bf, g, q, y);
    if (per_step && j + 2 < steps) load_frags(bf, t - 2, 1);
    {
      const int jn = j + kStages - 1;
      if (jn < steps) stage(jn % kStages, 0, steps - 1 - jn, false);
      cp_async_commit();
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const int r = (8 * m + g) * St::kLe + c0;
      const double2 E = *reinterpret_cast<const double2*>(st + St::kE + r);
      const double2 A = *reinterpret_cast<const double2*>(st + St::kA + r);
      const double b0 = y[m][0] * s[m], b1 = y[m][1] * s[m];
      Xout[(8 * m + g) * kLd + c0] = col[0] ? b0 * E.x : 0.0;
      Xout[(8 * m + g) * kLd + c0 + 1] = col[1] ? b1 * E.y : 0.0;
      if (live[m] && col[0] && kStores) p[m][(size_t)t * S + c0] = A.x * b0;
      if (live[m] && col[1] && kStores) p[m][(size_t)t * S + c0 + 1] = A.y * b1;
    }
  };
  for (int j = 0; j < steps; j += 2) {
    backward_step(j, bfa);
    if (j + 1 < steps) backward_step(j + 1, bfb);
  }
  cp_async_wait<0>();
}

// post[b][t][c] = log10(u[c]) - log10(sum_c u[c]) of every row (b, t): a row
// a warp (S <= 64), lane l holding states l and l + 32; the sum adds them,
// then a shfl_down tree (offsets 16, 8, 4, 2, 1) into lane 0
__global__ void __launch_bounds__(256)
fb_posterior_kernel(double* __restrict__ post, long long rows, int S) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); row < rows;
       row += warps) {
    double* u = post + row * S;
    const double u0 = lane < S ? u[lane] : 0.0, u1 = lane + 32 < S ? u[lane + 32] : 0.0;
    double x = u0 + u1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
    const double lt = log10(__shfl_sync(kFull, x, 0));
    if (lane < S) u[lane] = log10(u0) - lt;
    if (lane + 32 < S) u[lane + 32] = log10(u1) - lt;
  }
}

// the shared memory of fb_product_kernel<kMT, kSp, kStages>
template <int kMT, int kSp, int kStages>
constexpr size_t product_smem() {
  return sizeof(double) * ((size_t)kStages * Stage<kSp, 8 * kMT>::kDoubles +
                           2 * 8 * kMT * (kSp + 4) + (kSp / 8) * 8 * kMT);
}

#ifndef FB_STAGES
#define FB_STAGES 4  // the ring's stages, where they fit
#endif

template <int kMT, int kSp>
int product_launch(const double* start, const double* P, const double* gmax, const double* Eh,
                   const double* emit, int n, int T, int S, int per_step, double* post, double* ll,
                   cudaStream_t stream) {
  // FB_STAGES stages where they fit, else one fewer (four at 8 and at 16
  // samples a block, S 64)
  constexpr int kStages =
      product_smem<kMT, kSp, FB_STAGES>() <= 227 * 1024 ? FB_STAGES : FB_STAGES - 1;
  constexpr size_t smem = product_smem<kMT, kSp, kStages>();
  const cudaError_t rc = cudaFuncSetAttribute(fb_product_kernel<kMT, kSp, kStages>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  fb_product_kernel<kMT, kSp, kStages><<<(n + 8 * kMT - 1) / (8 * kMT), 4 * kSp, smem, stream>>>(
      start, P, gmax, Eh, emit, n, T, S, per_step, post, ll);
  const cudaError_t e = cudaGetLastError();
#ifdef FB_ABLATE_POSTERIOR
  return (int)e;  // ablation: the recursions alone
#endif
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long rows = (long long)n * T;
  long long blocks = (rows + 7) / 8;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  fb_posterior_kernel<<<(int)blocks, 256, 0, stream>>>(post, rows, S);
  return (int)cudaGetLastError();
}

template <int kMT>
int product_launch_by_states(const double* start, const double* P, const double* gmax,
                             const double* Eh, const double* emit, int n, int T, int S,
                             int per_step, double* post, double* ll, cudaStream_t stream) {
  switch ((S + 7) / 8) {
    case 1: return product_launch<kMT, 8>(start, P, gmax, Eh, emit, n, T, S, per_step, post, ll, stream);
    case 2: return product_launch<kMT, 16>(start, P, gmax, Eh, emit, n, T, S, per_step, post, ll, stream);
    case 3: return product_launch<kMT, 24>(start, P, gmax, Eh, emit, n, T, S, per_step, post, ll, stream);
    case 4: return product_launch<kMT, 32>(start, P, gmax, Eh, emit, n, T, S, per_step, post, ll, stream);
    case 5: return product_launch<kMT, 40>(start, P, gmax, Eh, emit, n, T, S, per_step, post, ll, stream);
    case 6: return product_launch<kMT, 48>(start, P, gmax, Eh, emit, n, T, S, per_step, post, ll, stream);
    case 7: return product_launch<kMT, 56>(start, P, gmax, Eh, emit, n, T, S, per_step, post, ll, stream);
    case 8: return product_launch<kMT, 64>(start, P, gmax, Eh, emit, n, T, S, per_step, post, ll, stream);
  }
  return (int)cudaErrorInvalidValue;
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

// the product form's prologue: start (S,), trans (nM, S, S), emit (n, T, S)
// f64 contiguous, S <= 64; writes P (nM, 2, Sp, Sp), gmax (nM,), Eh (n, T, S)
// and the three spreads into stats (3 x u64, zeroed by the caller)
extern "C" int fb_prepare_launch(const void* start, const void* trans, const void* emit, int n,
                                 int T, int S, int nM, void* P, void* gmax, void* Eh, void* stats,
                                 void* stream) {
  if (S < 1 || S > kProductMaxStates || n < 0 || T < 1 || nM < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // a block a matrix, 8 emission rows a block, at most 4 blocks an SM
  const long long rows = (long long)n * T, by_rows = (rows + 7) / 8;
  long long blocks = nM > by_rows ? nM : by_rows;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  if (blocks < 1) blocks = 1;
  fb_prepare_kernel<<<(int)blocks, kPrepThreads, 0, (cudaStream_t)stream>>>(
      (const double*)start, (const double*)trans, (const double*)emit, n, T, S, nM, (double*)P,
      (double*)gmax, (double*)Eh, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

// the product form: P, gmax and Eh from fb_prepare_launch, per_step as the
// transitions were; the recursions (8 x mt samples a block, mt 1 or 2), then
// the posterior pass
extern "C" int fb_product_launch(const void* start, const void* P, const void* gmax,
                                 const void* Eh, const void* emit, int n, int T, int S,
                                 int per_step, int mt, void* post, void* ll, void* stream) {
  if (n <= 0 || T <= 0) return (int)cudaGetLastError();
  if (S < 1 || S > kProductMaxStates) return (int)cudaErrorInvalidValue;
  const double* s = (const double*)start;
  const double* p = (const double*)P;
  const double* gm = (const double*)gmax;
  const double* h = (const double*)Eh;
  const double* e = (const double*)emit;
  double* po = (double*)post;
  double* l = (double*)ll;
  const cudaStream_t st = (cudaStream_t)stream;
  if (mt == 1) return product_launch_by_states<1>(s, p, gm, h, e, n, T, S, per_step, po, l, st);
  if (mt == 2) return product_launch_by_states<2>(s, p, gm, h, e, n, T, S, per_step, po, l, st);
  return (int)cudaErrorInvalidValue;
}
