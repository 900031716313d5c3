// Per-position pileup histogram by shear.
//
// Replaces the Pallas kernel in ngsepcore_tpu/kernels/shear_pileup.py:227
// (_shear_hist_jit, body _hist_kernel :90).  Semantics are those of
// kernels/shear_pileup.py:shear_hist_ref in this package:
//
//   out[p, c] = #{ o < lanes : stage_t[o, w0s + p - o] counts in column c }
//
// where a stage byte v (0xFF = empty) with col = v & 127 counts in column
// col when col < 4*nq+2, and an SNV byte (col < 4*nq, allele
// al = col / nq) also counts in strand column 120 + al*2 + (v >> 7).
//
// One thread per output position, T positions per block.  For a fixed o,
// neighbouring threads read neighbouring bytes of stage row o, so every
// load is coalesced.  Each thread counts into its own column of a
// (bins, T+1) int32 tile in shared memory: no atomics, deterministic.  The
// tile is then written out as T rows of 128 int32, coalesced.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStrandCol0 = 120;

__global__ void shear_hist_kernel(const uint8_t* __restrict__ stage_t,
                                  int S, int w0s, int window, int nq,
                                  int lanes, int* __restrict__ out) {
  extern __shared__ int acc[];  // acc[bin * (T+1) + thread]
  const int T = blockDim.x;
  const int ld = T + 1;  // padded stride: the write-out reads rows of acc
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * T;
  const int p = p0 + tid;
  const int ncnt = 4 * nq + 2;
  const int bins = ncnt + 8;
  for (int k = 0; k < bins; ++k) acc[k * ld + tid] = 0;
  if (p < window) {
    const uint8_t* src = stage_t + (size_t)(w0s + p);
    for (int o = 0; o < lanes; ++o) {
      const int v = src[(size_t)o * S - o];
      const int col = v & 127;
      if (col < ncnt) acc[col * ld + tid] += 1;
      if (col < 4 * nq) {
        const int al = (col >= nq) + (col >= 2 * nq) + (col >= 3 * nq);
        acc[(ncnt + al * 2 + (v >> 7)) * ld + tid] += 1;
      }
    }
  }
  __syncthreads();
  const int rows = min(T, window - p0);
  for (int i = tid; i < rows * 128; i += T) {
    const int pp = i >> 7;
    const int cc = i & 127;
    int v = 0;
    if (cc < ncnt) {
      v = acc[cc * ld + pp];
    } else if (cc >= kStrandCol0) {
      v = acc[(ncnt + cc - kStrandCol0) * ld + pp];
    }
    out[(size_t)(p0 + pp) * 128 + cc] = v;
  }
}

}  // namespace

extern "C" int shear_hist_launch(const void* stage_t, int S, int w0s,
                                 int window, int nq, int lanes, void* out,
                                 void* stream) {
  if (window <= 0) return (int)cudaGetLastError();
  const int bins = 4 * nq + 2 + 8;
  const size_t shmem = (size_t)bins * (kThreads + 1) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      shear_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (window + kThreads - 1) / kThreads;
  shear_hist_kernel<<<blocks, kThreads, shmem, (cudaStream_t)stream>>>(
      (const uint8_t*)stage_t, S, w0s, window, nq, lanes, (int*)out);
  return (int)cudaGetLastError();
}
