// Gotoh affine-gap forward pass emitting the packed run/pointer plane.
//
// Replaces the Pallas kernel ngsepcore_tpu/kernels/pairwise_pallas.py:243
// (gotoh_forward_plane_pallas).  Semantics and the plane layout are those
// of kernels/pairwise_cuda.py:gotoh_forward_plane_ref, which this kernel
// matches bit for bit on every cell.
//
// One block per alignment b, one thread per subject column c = t+1.  The
// block walks the query rows in order.  Per row:
//   phase A  M/I and their run carries from the previous row (own column
//            in registers, diagonal neighbour from shared memory);
//   scan 1   block-wide inclusive max of y[h] = A[h] + ext*h, seeded with
//            the column-0 value, gives D[c] = Y[c-1] - ext*(c-1);
//   phase B  D-open pointer from column c-1, then scan 2 (inclusive max of
//            c*4 + dp) gives the D-run source and length;
//   write    the row of the plane, coalesced, then publish this row's
//            M/I/D/em/sm to shared memory for the next row.
// Rows past qlen freeze M/I/D/em/ei/sm/si (the plane's sd/ed stay fresh,
// as in the plain version).
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kNeg = -10000000;

__device__ __forceinline__ int warp_incl_max(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, n);
  }
  return v;
}

// Block-wide inclusive max-scan over threadIdx.x order.  `warp_tot` holds
// 32 ints of shared memory; the trailing barrier lets callers reuse it.
__device__ __forceinline__ int block_incl_max(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_incl_max(v, lane);
  if (lane == 31) warp_tot[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? warp_tot[lane] : INT_MIN;
    t = warp_incl_max(t, lane);
    if (lane < nw) warp_tot[lane] = t;
  }
  __syncthreads();
  if (wid > 0) v = max(v, warp_tot[wid - 1]);
  __syncthreads();
  return v;
}

__device__ __forceinline__ long long warp_max64(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    long long n = __shfl_xor_sync(0xffffffffu, v, o);
    v = v > n ? v : n;
  }
  return v;
}

__global__ void gotoh_forward_kernel(
    const int8_t* __restrict__ query, const int* __restrict__ qlen,
    const int8_t* __restrict__ subject, const int* __restrict__ slen,
    int* __restrict__ plane, int* __restrict__ score_out,
    int* __restrict__ endj_out, int* __restrict__ startk_out,
    int B, int Lq, int Ls, int match, int mismatch, int open_gap,
    int ext_gap, int free_start2, int free_end2) {
  extern __shared__ int smem[];
  __shared__ int warp_tot[32];
  __shared__ long long warp_best[32];
  const int S = Ls + 1;
  int* pM = smem;       // previous row M, columns 0..Ls
  int* pI = pM + S;     // previous row I
  int* pD = pI + S;     // previous row D
  int* pEM = pD + S;    // previous row M-run length
  int* pSM = pEM + S;   // previous row M-run source pointer
  int* sY = pSM + S;    // this row's scan of A[h] + ext*h
  int* sAM = sY + S;    // this row's M - open
  int* sAI = sAM + S;   // this row's I - open
  int* sDr = sAI + S;   // this row's D (before the freeze)

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int c = t + 1;
  const bool col = c <= Ls;
  const int ql = qlen[b];
  const int sl = slen[b];
  const int s_ch = col ? subject[(size_t)b * Ls + t] : 0;
  const int8_t* qrow = query + (size_t)b * Lq;

  int m_p = kNeg, i_p = kNeg;
  int d_p = free_start2 ? 0 : -open_gap - ext_gap * (c - 1);
  int em_p = 0, ei_p = 0, sm_p = 0, si_p = 0;
  if (col) {
    pM[c] = m_p; pI[c] = i_p; pD[c] = d_p; pEM[c] = 0; pSM[c] = 0;
  }
  if (t == 0) {
    pM[0] = 0; pI[0] = 0; pD[0] = 0; pEM[0] = 0; pSM[0] = 0;
  }
  __syncthreads();

  for (int r = 1; r <= Lq; ++r) {
    const int q = qrow[r - 1];
    const bool active = r <= ql;
    const int i0n = -open_gap - ext_gap * (r - 1);  // column 0 of row r
    const int am0 = kNeg - open_gap;
    const int ai0 = i0n - open_gap;
    const int a0 = max(am0, ai0);

    int m_row = kNeg, i_row = kNeg, em_row = 0, sm_row = 0;
    int ei_row = 0, si_row = 0, y = INT_MIN;
    if (col) {
      const int sub = s_ch == q ? match : -mismatch;
      const int mpd = pM[c - 1], ipd = pI[c - 1], dpd = pD[c - 1];
      m_row = max(max(mpd, ipd), dpd) + sub;
      const int mp = mpd >= max(ipd, dpd) ? 0 : (ipd >= dpd ? 1 : 2);
      em_row = min(1 + (mp == 0 ? pEM[c - 1] : 0), 255);
      sm_row = mp != 0 ? mp : pSM[c - 1];
      const int cm = m_p - open_gap, ci = i_p - ext_gap, cd = d_p - open_gap;
      i_row = max(max(cm, ci), cd);
      const int ip = cm >= max(ci, cd) ? 0 : (ci >= cd ? 1 : 2);
      ei_row = min(1 + (ip == 1 ? ei_p : 0), 255);
      si_row = ip != 1 ? ip : si_p;
      const int am = m_row - open_gap, ai = i_row - open_gap;
      sAM[c] = am;
      sAI[c] = ai;
      y = max(am, ai) + ext_gap * c;
    }
    const int Y = max(block_incl_max(y, warp_tot), a0);
    if (col) sY[c] = Y;
    if (t == 0) {
      sY[0] = a0; sAM[0] = am0; sAI[0] = ai0; sDr[0] = kNeg;
    }
    __syncthreads();
    int d_row = kNeg;
    if (col) {
      d_row = sY[c - 1] - ext_gap * (c - 1);
      sDr[c] = d_row;
    }
    __syncthreads();
    int ov = INT_MIN;
    if (col) {
      const int amp = sAM[c - 1], aip = sAI[c - 1];
      const bool opened = max(amp, aip) >= sDr[c - 1] - ext_gap;
      const int dp = opened ? (amp >= aip ? 0 : 1) : 2;
      ov = dp != 2 ? c * 4 + dp : -1;
    }
    const int orun = max(block_incl_max(ov, warp_tot), 0);  // column 0: 0
    if (!active) {
      m_row = m_p; i_row = i_p; d_row = d_p;
      em_row = em_p; ei_row = ei_p; sm_row = sm_p; si_row = si_p;
    }
    if (col) {
      const unsigned sd = orun & 3;
      const unsigned ed = min(c - (orun >> 2) + 1, 255);
      const unsigned w = (unsigned)sm_row | ((unsigned)si_row << 2) |
                         (sd << 4) | ((unsigned)em_row << 8) |
                         ((unsigned)ei_row << 16) | (ed << 24);
      plane[((size_t)(r - 1) * B + b) * Ls + t] = (int)w;
      pM[c] = m_row; pI[c] = i_row; pD[c] = d_row;
      pEM[c] = em_row; pSM[c] = sm_row;
    }
    if (t == 0 && active) {
      pM[0] = kNeg; pI[0] = i0n; pD[0] = kNeg;
    }
    m_p = m_row; i_p = i_row; d_p = d_row;
    em_p = em_row; ei_p = ei_row; sm_p = sm_row; si_p = si_row;
    __syncthreads();
  }

  if (free_end2) {
    // best M over columns 0..Ls (columns past slen count as kNeg); ties go
    // to the largest column: maximise (value, column) packed in 64 bits
    constexpr long long kCol = 1LL << 32;
    long long key = LLONG_MIN;
    if (col) key = (long long)(c <= sl ? pM[c] : kNeg) * kCol + c;
    if (t == 0) {
      const long long k0 = (long long)pM[0] * kCol;  // column 0 <= slen
      key = key > k0 ? key : k0;
    }
    key = warp_max64(key);
    if ((t & 31) == 0) warp_best[t >> 5] = key;
    __syncthreads();
    if (t == 0) {
      long long best = warp_best[0];
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
        best = warp_best[w] > best ? warp_best[w] : best;
      const int ej = (int)(best & 0xffffffffLL);
      score_out[b] = (int)((best - ej) / kCol);
      endj_out[b] = ej;
      startk_out[b] = 0;
    }
  } else if (t == 0) {
    const int sc = min(max(sl, 0), Ls);  // callers keep slen <= Ls
    const int mc = pM[sc], ic = pI[sc], dc = pD[sc];
    int score = mc, sk = 0;
    if (ic > mc) { score = ic; sk = 1; }
    if (dc > score) score = dc;
    if (dc > max(mc, ic)) sk = 2;
    score_out[b] = score;
    endj_out[b] = sl;
    startk_out[b] = sk;
  }
}

}  // namespace

extern "C" int gotoh_forward_launch(
    const void* query, const void* qlen, const void* subject,
    const void* slen, void* plane, void* score, void* end_j, void* start_k,
    int B, int Lq, int Ls, int match, int mismatch, int open_gap,
    int ext_gap, int free_start2, int free_end2, void* stream) {
  if (B <= 0 || Lq <= 0) return (int)cudaGetLastError();
  const int threads = ((Ls + 31) / 32) * 32;
  const size_t shmem = (size_t)9 * (Ls + 1) * sizeof(int);
  gotoh_forward_kernel<<<B, threads, shmem, (cudaStream_t)stream>>>(
      (const int8_t*)query, (const int*)qlen, (const int8_t*)subject,
      (const int*)slen, (int*)plane, (int*)score, (int*)end_j,
      (int*)start_k, B, Lq, Ls, match, mismatch, open_gap, ext_gap,
      free_start2, free_end2);
  return (int)cudaGetLastError();
}
