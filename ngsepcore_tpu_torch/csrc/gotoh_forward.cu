// Gotoh affine-gap forward pass emitting the packed run/pointer plane.
//
// Replaces the Pallas kernel ngsepcore_tpu/kernels/pairwise_pallas.py:243
// (gotoh_forward_plane_pallas).  Semantics and the plane layout are those
// of kernels/pairwise_cuda.py:gotoh_forward_plane_ref, which every kernel
// of this file matches bit for bit on every cell of the plane.
//
// What bounds the function on an H100 (SXM: 3.35 TB/s; 132 SMs with 64
// INT32 lanes each at 1.98 GHz, about 16.7 T integer operations a second;
// no tensor-core work):
//   bytes       the (Lq, B, Ls) int32 plane is written once and the int8
//               inputs are read once: 302.0 MB at 2048x192x192, 0.090 ms;
//   operations  45 integer operations a cell as the warp kernel below does
//               the arithmetic (M with its pointer and run carry 12, I 12,
//               D with both scans 13, run fields, packing and the store 8):
//               75.5 M cells x 45 / 16.7 T = 0.203 ms at 2048x192x192.
// INT32 issue is the larger bound at every shape, so the design spends no
// time on block barriers or shared-memory round trips and keeps the
// per-cell instruction count down (68 SASS instructions a cell at K = 6,
// moves, addresses, shuffles and the tile included).
//
// Times quoted in these notes: gotoh_bench.py on an NVIDIA H100 80GB HBM3
// at a 700 W power limit, medians of CUDA-event timings.
//
// gotoh_forward_warp_kernel<K>, 1 <= Ls <= 256: ONE WARP PER ALIGNMENT.
//   * Lane l owns the K = ceil(Ls/32) contiguous columns l*K+1 .. l*K+K
//     and keeps their previous-row M, I, D and run carries in registers.
//     The carries are the previous row's plane word, masked: cwm holds the
//     M fields (sm | em<<8), cwi the I fields (si<<2 | ei<<16); a
//     saturating run-length increment is min(x + one, x | field_mask).
//     Interleaved columns (c = lane + 32k) would store without a tile but
//     need a warp scan for every k: 0.290 against 0.235 ms at
//     2048x192x192.
//   * Each column turns its previous-row state into what its diagonal
//     successor needs (hd = max(M, I, D) and the successor's M fields), so
//     the hand-off is a register rename inside a lane and two
//     __shfl_up_sync between lanes; lane 0 takes column 0's boundary.
//   * D[c] = max_{h<c}(A[h] + ext*h) - ext*(c-1) and the D-run source
//     (latest column whose D pointer is not "extend", packed col*4 + ptr)
//     are two exclusive max-scans over the row.  Each is a sequential pass
//     over the lane's own columns, one 5-step warp scan of the lane
//     totals, and a second pass that applies the lane's prefix.  "The D
//     pointer of column h+1 opens" is y[h] >= prefix[h], so the second
//     scan needs no D values.
//   * No __syncthreads() and no shared state in the row loop.  The row
//     leaves through a per-warp shared tile (padded one word per 32, so
//     the lane-contiguous writes and the coalesced reads are free of bank
//     conflicts; two __syncwarp) and is stored as whole 128-byte lines,
//     one per warp instruction.  Streaming stores (__stcs) for the plane,
//     which does not fit the 50 MB L2, measured 2-4% slower and are not
//     used.
//   * kWarps = 4 alignments a block, so 2048 alignments put 15-16
//     resident warps on each SM; the K columns a lane owns give the
//     instruction-level parallelism that this low occupancy needs.  Eight
//     a block is 2-4% faster at 2048 alignments but 46% slower at 256
//     (two warps share a scheduler on 32 SMs); two a block changes nothing.
//   * Rows past qlen are warp-uniform: the state is simply not committed,
//     while sd/ed are computed fresh, as the plain version does.
//
// gotoh_forward_seg_kernel<K>, 256 < Ls <= kSegMaxLs (3,584): THE WARP
// KERNEL'S ROW SPLIT OVER THE W = ceil(Ls/256) WARPS OF ONE BLOCK, one
// alignment a block, K = ceil(Ls/(32W)) columns a lane (4 to 8; with a
// free query end W = ceil(Ls/224) and K at most 7, see below).
//   * Warp w owns columns w*32K+1 .. (w+1)*32K, lane l of it K contiguous
//     ones, and runs the warp kernel's row body (the same source, kSeg):
//     M, I, D, run carries and subject codes in registers, no scratch in
//     global memory.
//   * Four ints cross a warp boundary a row, written by lane 31 of warp
//     w-1: after its row r, the inclusive maxima of y = A + ext*c and of
//     the packed D-run source z over every column left of warp w (seeded
//     with column 0's values), and the diagonal hand-off (hd, mw) of its
//     last column for row r+1.  Warp w seeds its own blocked scans with the
//     two maxima and passes max(incoming, own total) on: one max a hop.  I
//     is column-local, and D and its pointer come from the prefix.
//   * The messages sit in a shared ring of kRing rows a boundary (SegLink):
//     slot r holds row r's maxima and the hand-off into row r, is published
//     by a release store of r and freed by the consumer's release store of
//     the last row it read.  Warp w waits for row r's slot before it starts
//     the row, so the row's body is one stretch of code for ptxas: waiting
//     in the middle of the row (after the y pass) kept more values live
//     across the wait, and the K = 8 variants spilled 16-168 bytes and ran
//     0.7932 against 0.6575 ms at 512x512x512.  Warp w-1 may be up to
//     kRing rows ahead, warp w is one row behind it at the least, and no
//     __syncthreads() runs in the row loop.
//   * Bound, like the warp kernel's, by INT32 issue; the hand-off adds
//     about 15 instructions a warp and row to the ~550 of its 32K cells
//     at K = 8.  The block kernel it replaced (a thread a column, 9 shared
//     arrays and 9 block barriers a row) ran at 22-25% of the bound
//     (1.4247-1.5782 ms at 512x512x512).
//   * Registers: 16 warps x 32 lanes x at most 128 registers fill an SM's
//     65,536, which the launch bound asks of ptxas.  Each quarter of the
//     register file holds a quarter of the warps, so any block of more
//     than 12 warps caps a thread at 128 (15 warps did not raise it); 8
//     warps and up to 255 registers (173 at K = 8) ran 13% slower at
//     256x160x1664: one block of 7 warps an SM.  At K = 8 the free_end1
//     variants spilled 4-16 bytes at 128 in every arrangement tried (the
//     running best, its row and the owner index on top of the row), so
//     free_end1 takes at most 7 columns a lane and kSegMaxLs is 16 x 32 x
//     7 = 3,584 for every configuration: the dispatch stays on Ls alone.
//
// gotoh_forward_cluster_kernel<K>, kSegMaxLs < Ls <= kClusterMaxLs
// (24,576): THE SEG KERNEL'S CHAIN OF WARPS OVER THE N BLOCKS OF A
// THREAD-BLOCK CLUSTER, one alignment a cluster (grid B x N, cluster dims
// (N,1,1), cudaLaunchKernelEx).  One block an alignment leaves an SM idle
// for every alignment short of 132, and the plane's memory caps a batch
// (the MSA's 4 GiB of plane: 69 alignments at 3,936 columns), so a wide
// row is split over the SMs of a cluster instead.
//   * Block c owns columns c*W*32K+1 .. (c+1)*W*32K; its warp v is warp
//     w = c*W + v of one chain and runs the same row body (kClusterRows):
//     state in registers, no global scratch, rows stored as whole lines.
//   * Inside a block the seg kernel's SegLink rings, unchanged.  Across a
//     block boundary lane 31 of block c's last warp writes the slot (the
//     y and z prefixes, the diagonal hand-off) into block c+1's links[0]
//     in distributed shared memory (mapa, st.shared::cluster) and
//     publishes seq with st.release.cluster; block c+1's warp 0 polls its
//     own shared memory with ld.acquire.cluster and returns done the same
//     way into block c's links[kSegMaxWarps].  Every poll is a local load,
//     every write that crosses a block a remote store.  The seg kernel's
//     .cta-scope flags would not order memory across blocks.
//   * A cluster barrier after the rings are set and another before any
//     block leaves (a neighbour may still write its done flag); with a
//     free subject end each block's best goes into rank 0's shared memory
//     and rank 0 reduces them after the second barrier.  free_end1 and the
//     global end are written by the thread that owns column slen, in any
//     block.
//   * Registers: the seg kernel's rules (launch bound 512 threads, 128
//     registers a thread, 16 warps a block).  Its extra state (which links
//     cross a block, the remote addresses) sits in shared memory
//     (ClusterLink), and it packs the subject codes four to a register;
//     even so its K = 7 free_end1 variants spilled 4-68 bytes in every
//     arrangement tried, so free_end1 takes at most 6 columns a lane here
//     and kClusterMaxLs is 8 x 16 x 32 x 6 = 24,576 for every
//     configuration.  0 spills in every variant that is built.
//   * Layout (cluster_layout, the same in kernels/pairwise_cuda.py): for
//     each N <= 8, the fewest warps W <= 16, then the fewest columns a
//     lane K (4-8, 6 with free_end1) that own every column with a column
//     in every block; warps past the row's end (only in the last block)
//     sit the rows out, because some widths (3,585 with free_end1) have no
//     layout without one.  Among the N, the least time of the busiest SM:
//     the B clusters in ceil(B/h) waves of the h clusters the card holds
//     at once (cudaOccupancyMaxActiveClusters, asked once a device and
//     layout), ceil(min(B,h)*N/SMs) blocks an SM a wave, a block's row
//     K * (3W + 4); then the fewest N.  A cluster runs at the pace of its
//     slowest block, so the SM with the most blocks sets the time; the 4/3
//     of a warp's row a block costs beyond its warps is measured.  GPC
//     boundaries make h smaller than the SM arithmetic (79 clusters of N
//     3, W 6 against 88; 15 of N 7, W 11 against 18).
//   * Measured (gotoh_bench.py --kernels; the wide kernel beside it): the
//     MSA's 69x3936x3936, N 3, W 6, K 7: 7.4730 ms, 38.5% of the bound,
//     against 23.9262 (N 1: 8.4995, N 2: 9.9107, N 4: 8.8515, N 7: 7.5270);
//     tier-2 flanks at 37 x 160 x 4,096 / 8,192 / 16,384: 0.2888-1.0246
//     ms against the wide kernel's 0.9737-5.0650.  Forced at 93x3392x3392
//     it runs 8.2715 ms against the seg kernel's 6.9022.
//
// gotoh_forward_wide_kernel, Ls > kClusterMaxLs: one block per alignment,
// thread t owning the C = ceil(Ls/1024) contiguous columns t*C+1 .. t*C+C,
// as the warp kernel's lanes own theirs.  The owned columns' previous-row
// M, I, D and run carries, and the row's values between passes, live in a
// global scratch of 8 ints a column that the wrapper allocates
// (interleaved by thread, so a warp's accesses coalesce); only each
// thread's last column crosses to its neighbour (a shuffle, or between
// warps shared memory), and the two max-scans are the warp kernel's
// blocked scans with a block scan of the thread totals (block_excl_max).
// Shared memory is O(threads), so no width limit is left short of the
// plane's own size.  A first, simple kernel: each cell moves ~80 bytes of
// scratch through L1/L2 on top of its plane word, and a row takes 8 block
// barriers; 0.949 ms at 256x160x1664, 19% of its operations bound.  It
// keeps only the widths past the cluster kernel's (Ls > 24,576), which no
// path of chip_smoke.py launches; phase 2 holds it forced at every width.
//
// gotoh_forward_launch picks the kernel BY SHAPE (Ls); nothing falls back
// from one to another.
//
// Free QUERY ends (the tier-2 STR flank alignments), every kernel:
//   * free_start1: column 0 of the I state is 0 in every row instead of
//     -open - ext*(r-1); everything derived from it (the column-0 D-open
//     test, lane 0's diagonal hand-off) follows unchanged.
//   * free_end1: the result is the best M[r][slen] over rows 0..qlen, ties
//     to the largest row.  The thread that owns column slen keeps a running
//     (value, row) maximum in two registers while the row is active; there
//     is no second pass over the plane.  end_i is written only here; in
//     the other configurations it is qlen and the wrapper returns that.
//   Both flags are template parameters of every kernel, so the tier-3
//   instantiations carry none of this (as a runtime select on column 0
//   alone the 256-row tier-3 shape ran 8% slower: 0.0871 against 0.0807 ms).
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kNeg = -10000000;
constexpr int kWarps = 4;      // alignments (warps) per block, warp kernel
constexpr int kMaxLaneCols = 8;  // widest register variant: Ls <= 256 a warp
constexpr int kSegMinLaneCols = 4;  // narrowest seg variant
constexpr int kSegEnd1LaneCols = 7;  // widest seg variant with free_end1
constexpr int kSegMaxWarps = 16;  // 16 x 32 threads x 128 registers = an SM's
constexpr int kSegMaxLs = kSegMaxWarps * 32 * kSegEnd1LaneCols;  // 3,584
constexpr int kRing = 8;  // rows of messages in flight across a warp boundary
constexpr int kClusterMaxCtas = 8;  // the portable thread-block cluster size
constexpr int kClusterEnd1LaneCols = 6;  // widest cluster variant with free_end1
constexpr int kClusterMaxLs =  // 8 x 16 x 32 x 6 = 24,576
    kClusterMaxCtas * kSegMaxWarps * 32 * kClusterEnd1LaneCols;

// what gotoh_forward_rows runs: one warp an alignment, the chain of warps of
// one block an alignment, or that chain over the blocks of a cluster
enum { kWarpRows, kSegRows, kClusterRows };

// ---------------------------------------------------------------------------
// the row body of the warp and seg kernels

// max(a, b) and whether a >= b.  Hopper's DPX form of this pair,
// __vibmax_s32, measured slower here (0.263 against 0.245 ms at
// 2048x192x192), so this is a plain max and a compare.
__device__ __forceinline__ int max_ge(int a, int b, bool* ge) {
  *ge = a >= b;
  return max(a, b);
}

// Inclusive max-scan over the lanes.  __shfl_up_sync hands lanes below the
// offset their own value back, which max() absorbs.
__device__ __forceinline__ int warp_scan_max(int v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    v = max(v, __shfl_up_sync(0xffffffffu, v, o));
  return v;
}

// Exclusive from inclusive: lane l gets max(seed, incl[l-1]), lane 0 seed.
__device__ __forceinline__ int excl_from_incl(int incl, int seed, int lane) {
  const int up = __shfl_up_sync(0xffffffffu, incl, 1);
  return lane == 0 ? seed : max(seed, up);
}

// What the diagonal successor of a cell needs from it: max(M, I, D) and
// the successor's M fields (sm | em<<8), from the cell's own M fields cwm.
__device__ __forceinline__ void diag_out(int m, int i, int d, int cwm,
                                         int* hd, int* mw) {
  bool i_ge_d, m_ge;
  const int mx = max_ge(i, d, &i_ge_d);
  *hd = max_ge(m, mx, &m_ge);
  const int grown = min(cwm + 0x100, cwm | 0xFF00);  // em saturates at 255
  *mw = m_ge ? grown : (i_ge_d ? 0x101 : 0x102);
}

__device__ __forceinline__ long long warp_max64(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    long long n = __shfl_xor_sync(0xffffffffu, v, o);
    v = v > n ? v : n;
  }
  return v;
}

// The seg kernel's messages from warp w-1 to warp w, in link[w]: slot[r %
// kRing] carries row r, the y and z prefixes (.x, .y, written after warp
// w-1's row r) and the diagonal hand-off (.z, .w, written after its row
// r-1); seq[r % kRing] = r publishes it and done = r frees the slots of
// the rows up to r.
struct SegLink {
  int4 slot[kRing];
  int seq[kRing];
  int done;
};

// The cluster kernel's link into warp v of a block: SegLink's fields and,
// for warp v, whether its links cross a block boundary and where it then
// writes (its done flags into the previous block's
// links[kSegMaxWarps].done, its messages into the next block's links[0]:
// shared::cluster addresses), and whether a warp follows it in the chain.
// The row loop reads them from shared memory where it needs them, so that
// they hold no register across the row.
struct ClusterLink {
  int4 slot[kRing];
  int seq[kRing];
  int done;
  int from_block, to_block, has_next;
  unsigned done_to, link_to;
};

// Block-scope acquire load and release store of a shared int: the seg
// kernel's flags.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(p)),
               "r"(v)
               : "memory");
}

// The cluster kernel's link between blocks, in distributed shared memory:
// the writer stores into the reader's block (mapa + st.shared::cluster),
// publishing with a cluster-scope release; the reader polls its own shared
// memory with a cluster-scope acquire.  The block-scope pair above does not
// order memory across blocks.
// volatile: read where it is used, so that no register holds it across
// the row loop
__device__ __forceinline__ int cluster_ctarank() {
  int v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  return v;
}

__device__ __forceinline__ int block_warps() {
  int v;
  asm volatile("mov.u32 %0, %%ntid.x;" : "=r"(v));
  return v >> 5;
}

__device__ __forceinline__ unsigned cluster_nctarank() {
  unsigned v;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(v));
  return v;
}

__device__ __forceinline__ int cluster_id() {
  int v;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(v));
  return v;
}

// the shared::cluster address of *p in block `rank` of the cluster
__device__ __forceinline__ unsigned dsmem_addr(const void* p, int rank) {
  unsigned a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(a)
      : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ int ld_acquire_cluster(const int* p) {
  int v;
  asm volatile("ld.acquire.cluster.shared::cta.b32 %0, [%1];"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cluster(unsigned a, int v) {
  asm volatile("st.release.cluster.shared::cluster.b32 [%0], %1;" ::"r"(a), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster(unsigned a, int x, int y) {
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};" ::"r"(a), "r"(x), "r"(y)
               : "memory");
}

__device__ __forceinline__ void st_cluster(unsigned a, long long v) {
  asm volatile("st.shared::cluster.b64 [%0], %1;" ::"r"(a), "l"(v) : "memory");
}

// every thread of every block of the cluster; release before, acquire after
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;" ::: "memory");
}

#define GOTOH_PARAMS                                                        \
  const int8_t *__restrict__ query, const int *__restrict__ qlen,           \
      const int8_t *__restrict__ subject, const int *__restrict__ slen,     \
      int *__restrict__ plane, int *__restrict__ score_out,                 \
      int *__restrict__ endi_out, int *__restrict__ endj_out,               \
      int *__restrict__ startk_out, int B, int Lq, int Ls, int match,       \
      int mismatch, int open_gap, int ext_gap, int free_start2, int free_end2
#define GOTOH_FWD                                                           \
  query, qlen, subject, slen, plane, score_out, endi_out, endj_out,         \
      startk_out, B, Lq, Ls, match, mismatch, open_gap, ext_gap,            \
      free_start2, free_end2

// The score a free subject end takes: the best (M, column) key of the
// alignment, ties to the largest column.
__device__ __forceinline__ void write_free_end2(long long key, int b, int* score_out,
                                                int* endj_out, int* startk_out) {
  constexpr long long kCol = 1LL << 32;
  const int ej = (int)(key & 0xffffffffLL);
  score_out[b] = (int)((key - ej) / kCol);
  endj_out[b] = ej;
  startk_out[b] = 0;
}

// kWarpRows: warp w of the block is alignment blockIdx.x * kWarps + w and
// owns all its columns.  kSegRows: the block is alignment blockIdx.x and
// warp w owns its columns w*32K+1 .. (w+1)*32K.  kClusterRows: the cluster
// is alignment %clusterid.x, and warp v of the block of rank c is warp w =
// c*nwb + v of one chain over the cluster's blocks.
template <int K, int kMode, bool kFreeStart1, bool kFreeEnd1>
__device__ __forceinline__ void gotoh_forward_rows(GOTOH_PARAMS) {
  constexpr bool kSeg = kMode != kWarpRows;  // the row split over a chain of warps
  constexpr bool kClu = kMode == kClusterRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwb = kSeg ? blockDim.x >> 5 : 1;  // the block's warps in the chain
  const int b = kClu ? cluster_id() : kSeg ? blockIdx.x : blockIdx.x * kWarps + warp;
  if (!kSeg && b >= B) return;  // whole warp; nothing below synchronises the block
  // the warp's segment of the row
  const int w = kClu ? cluster_ctarank() * nwb + warp : kSeg ? warp : 0;
  // warps of the chain: the cluster's last block may hold warps past the
  // row's end, which sit the rows out
  const int nw = kClu ? min((int)cluster_nctarank() * nwb, (Ls + 32 * K - 1) / (32 * K))
                      : nwb;
  // word i of a warp's row sits at tile[i + i/32]
  int* tile;
  if constexpr (kSeg) {
    extern __shared__ int seg_tiles[];
    tile = seg_tiles + warp * (K * 33);
  } else {
    __shared__ int tiles[kWarps][K * 33];
    tile = tiles[warp];
  }
  // seg: links[v] carries warp v-1's messages to warp v, in + 1 those to
  // warp v+1.  Cluster: links[kSegMaxWarps] holds only the done flag that
  // the next block's warp 0 writes back to the last warp; the messages
  // themselves go into that block's links[0].
  using Link = std::conditional_t<kClu, ClusterLink, SegLink>;
  __shared__ Link links[kClu ? kSegMaxWarps + 1 : kSeg ? kSegMaxWarps : 1];
  __shared__ long long cta_best[kClu ? kClusterMaxCtas : 1];  // free_end2, in rank 0
  Link* in = links + warp;
  const int ql = qlen[b];
  const int sl = slen[b];
  const int c0 = w * 32 * K + lane * K + 1;  // first owned column

  // previous-row state of the owned columns (columns past Ls compute
  // values nobody reads: the scans only look to the left).  The subject
  // codes: one a register, or in the cluster kernel four bytes a register
  // (s_pk), one more instruction a cell for K - ceil(K/4) registers; with
  // one a register its K = 6-8 variants spilled 4-68 bytes.
  int s_ch[kClu ? 1 : K], m[K], i[K], d[K], cwm[K], cwi[K];
  unsigned s_pk[kClu ? (K + 3) / 4 : 1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = c0 + k;
    const int code = c <= Ls ? subject[(size_t)b * Ls + c - 1] : 0;
    if constexpr (kClu) {
      const unsigned byte = (unsigned)(code & 0xFF) << (8 * (k & 3));
      s_pk[k >> 2] = (k & 3) ? s_pk[k >> 2] | byte : byte;
    } else {
      s_ch[k] = code;
    }
    m[k] = kNeg;
    i[k] = kNeg;
    d[k] = free_start2 ? 0 : -open_gap - ext_gap * (c - 1);
    cwm[k] = 0;
    cwi[k] = 0;
  }
  int m0 = 0, i0 = 0, d0 = 0;  // column 0 (its run carries stay 0)
  if constexpr (kSeg) {
    if (lane < kRing) in->seq[lane] = 0;
    if (lane == 0) {
      in->done = 0;
      if constexpr (kClu) {
        const int rank = cluster_ctarank();
        in->from_block = warp == 0;
        in->to_block = warp == nwb - 1;
        in->has_next = w + 1 < nw;
        if (warp == 0 && rank > 0)
          in->done_to = dsmem_addr(&links[kSegMaxWarps].done, rank - 1);
        if (warp == nwb - 1) {
          links[kSegMaxWarps].done = 0;
          if (w + 1 < nw) in->link_to = dsmem_addr(links, rank + 1);
        }
      }
      // row 1's hand-off into column w*32K+1: column w*32K's initial state
      const int cb = w * 32 * K;
      int2* hand = reinterpret_cast<int2*>(&in->slot[1 % kRing]) + 1;
      diag_out(kNeg, kNeg, free_start2 ? 0 : -open_gap - ext_gap * (cb - 1), 0,
               &hand->x, &hand->y);
    }
    // every ring is set before any warp, of this block or a neighbour, writes
    if constexpr (kClu) {
      cluster_sync();
    } else {
      __syncthreads();
    }
  }
  // free_end1: running best M[r][sl] of the lane that owns column sl, ties
  // to the largest row.  Row 0 counts (as 0) only when sl == 0; rows past
  // qlen count as kNeg, so an alignment with no active row ends at Lq.
  const int own = sl - c0;  // index of column sl among the owned columns
  int best = sl == 0 ? 0 : kNeg;
  int brow = sl == 0 ? 0 : Lq;

  const int8_t* qrow = query + (size_t)b * Lq;
  const size_t row_stride = (size_t)B * Ls;
  int* prow = plane + (size_t)b * Ls + w * 32 * K;
  const int cols = Ls - w * 32 * K;  // columns of the row from the warp's first
  const int neg_mismatch = -mismatch;
  int q_next = qrow[0];

  if (!kClu || w < nw)
  for (int r = 1; r <= Lq; ++r) {
    const int q = q_next;
    if (r < Lq) q_next = qrow[r];  // in flight during this row
    const bool active = r <= ql;   // uniform over the block
    // column 0 of row r
    const int i0n = kFreeStart1 ? 0 : -open_gap - ext_gap * (r - 1);
    const int am0 = kNeg - open_gap;
    const int ai0 = i0n - open_gap;
    const int a0 = max(am0, ai0);
    // seg, w > 0: warp w-1's message for row r, awaited before the row so
    // that the row's body stays one stretch of code for the scheduler
    int4 msg = make_int4(0, 0, 0, 0);
    if constexpr (kSeg) {
      if (w > 0) {
        const int slot = r % kRing;
        if constexpr (kClu) {
          if (in->from_block) {  // from the previous block's last warp
            while (ld_acquire_cluster(&in->seq[slot]) != r) {
            }
          } else {
            while (ld_acquire(&in->seq[slot]) != r) {
            }
          }
        } else {
          while (ld_acquire(&in->seq[slot]) != r) {
          }
        }
        msg = in->slot[slot];
        __syncwarp();  // every lane has read the slot
        if (lane == 0) {
          if constexpr (kClu) {
            if (in->from_block) {
              st_release_cluster(in->done_to, r);
            } else {
              st_release(&in->done, r);
            }
          } else {
            st_release(&in->done, r);
          }
        }
      }
    }

    // diagonal hand-off from the previous row
    int hd[K], mw[K];
#pragma unroll
    for (int k = 0; k < K; ++k) diag_out(m[k], i[k], d[k], cwm[k], &hd[k], &mw[k]);
    int hd_in = __shfl_up_sync(0xffffffffu, hd[K - 1], 1);
    int mw_in = __shfl_up_sync(0xffffffffu, mw[K - 1], 1);
    if (lane == 0) {
      if (kSeg && w > 0) {
        hd_in = msg.z;
        mw_in = msg.w;
      } else {
        diag_out(m0, i0, d0, 0, &hd_in, &mw_in);
      }
    }

    // M, I, y = A + ext*c and the lane's running max of y
    int m_row[K], i_row[K], cwi_row[K], y[K], run[K];
    bool m_ge_i[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool hit = kClu ? ((s_pk[k >> 2] >> (8 * (k & 3))) & 0xFF) == (q & 0xFF)
                            : s_ch[k] == q;
      m_row[k] = (k == 0 ? hd_in : hd[k - 1]) + (hit ? match : neg_mismatch);
      const int cm = m[k] - open_gap, ci = i[k] - ext_gap, cd = d[k] - open_gap;
      bool ci_ge_cd, cm_ge;
      const int mx = max_ge(ci, cd, &ci_ge_cd);
      i_row[k] = max_ge(cm, mx, &cm_ge);
      const int grown = min(cwi[k] + 0x10000, cwi[k] | 0xFF0000);
      // ip = 0: from M (si 0), 1: extend, 2: from D (si 2); ei restarts at 1
      cwi_row[k] = cm_ge ? 0x10000 : (ci_ge_cd ? grown : 0x10008);
      const int a = max_ge(m_row[k], i_row[k], &m_ge_i[k]) - open_gap;
      y[k] = a + ext_gap * (c0 + k);
      run[k] = k == 0 ? y[0] : max(run[k - 1], y[k]);
    }
    // the scans' seeds: column 0, or in the seg kernel warp w-1's prefixes
    const int yincl = warp_scan_max(run[K - 1]);
    const int yseed = kSeg && w > 0 ? msg.x : a0;
    const int pre = excl_from_incl(yincl, yseed, lane);

    // D of this row; z = packed source if column c+1's D pointer opens
    // from this column (y >= everything to its left), else -1
    int d_row[K], zrun[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + k;
      const int left = k == 0 ? pre : max(pre, run[k - 1]);
      d_row[k] = left - ext_gap * (c - 1);
      const int z = y[k] >= left ? (c + 1) * 4 + (m_ge_i[k] ? 0 : 1) : -1;
      zrun[k] = k == 0 ? z : max(zrun[k - 1], z);
    }
    // column 0: its D is banned, so column 1 opens unless a0 is banned too
    const int z0 = a0 >= kNeg - ext_gap ? 4 + (am0 >= ai0 ? 0 : 1) : -1;
    const int zincl = warp_scan_max(zrun[K - 1]);
    const int zseed = kSeg && w > 0 ? msg.y : max(z0, 0);
    const int zpre = excl_from_incl(zincl, zseed, lane);

    if (active) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        m[k] = m_row[k];
        i[k] = i_row[k];
        d[k] = d_row[k];
        cwm[k] = k == 0 ? mw_in : mw[k - 1];
        cwi[k] = cwi_row[k];
      }
      m0 = kNeg;
      i0 = i0n;
      d0 = kNeg;
      if (kFreeEnd1) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k == own && m[k] >= best) {
            best = m[k];
            brow = r;
          }
        }
      }
    }

    if constexpr (kSeg && !kClu) {
      // to warp w+1: row r's prefixes, and row r+1's hand-off into the slot
      // of row r+1 once warp w+1 has read row r+1 - kRing from it
      if (w + 1 < nw) {
        Link* out = in + 1;
        while (r + 1 > kRing && ld_acquire(&out->done) < r + 1 - kRing) {
        }
        if (lane == 31) {
          int2* pre_r = reinterpret_cast<int2*>(&out->slot[r % kRing]);
          int2* hand = reinterpret_cast<int2*>(&out->slot[(r + 1) % kRing]) + 1;
          *pre_r = make_int2(max(yseed, yincl), max(zseed, zincl));
          diag_out(m[K - 1], i[K - 1], d[K - 1], cwm[K - 1], &hand->x, &hand->y);
          st_release(&out->seq[r % kRing], r);
        }
      }
    }
    if constexpr (kClu) {
      // the same, from the last warp of a block into the next block
      if (in->has_next) {
        if (in->to_block) {  // to the next block's warp 0
          const int* done = &links[kSegMaxWarps].done;
          while (r + 1 > kRing && ld_acquire_cluster(done) < r + 1 - kRing) {
          }
        } else {
          while (r + 1 > kRing && ld_acquire(&in[1].done) < r + 1 - kRing) {
          }
        }
        if (lane == 31) {
          int2 hand;
          diag_out(m[K - 1], i[K - 1], d[K - 1], cwm[K - 1], &hand.x, &hand.y);
          if (in->to_block) {
            // into the next block's links[0]: slots of 16 bytes, seq words of 4
            const unsigned slots = in->link_to + (unsigned)offsetof(ClusterLink, slot);
            const unsigned seq = in->link_to + (unsigned)offsetof(ClusterLink, seq);
            st_cluster(slots + 16u * (r % kRing), max(yseed, yincl), max(zseed, zincl));
            st_cluster(slots + 16u * ((r + 1) % kRing) + 8u, hand.x, hand.y);
            st_release_cluster(seq + 4u * (r % kRing), r);
          } else {
            Link* out = in + 1;
            *reinterpret_cast<int2*>(&out->slot[r % kRing]) =
                make_int2(max(yseed, yincl), max(zseed, zincl));
            reinterpret_cast<int2*>(&out->slot[(r + 1) % kRing])[1] = hand;
            st_release(&out->seq[r % kRing], r);
          }
        }
      }
    }

#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + k;
      const int orun = k == 0 ? zpre : max(zpre, zrun[k - 1]);
      const int sd = orun & 3;
      const int ed = min(c - (orun >> 2) + 1, 255);
      const int idx = lane * K + k;
      tile[idx + (idx >> 5)] = cwm[k] | cwi[k] | (sd << 4) | (ed << 24);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int idx = j * 32 + lane;
      if (idx < cols) prow[idx] = tile[idx + j];
    }
    __syncwarp();
    prow += row_stride;
  }

  if (kFreeEnd1) {
    if ((own >= 0 && own < K) || (sl == 0 && w == 0 && lane == 0)) {
      score_out[b] = best;
      endi_out[b] = brow;
      endj_out[b] = sl;
      startk_out[b] = 0;
    }
  } else if (free_end2) {
    // best M over columns 0..Ls (columns past slen count as kNeg); ties go
    // to the largest column: maximise (value, column) packed in 64 bits
    constexpr long long kCol = 1LL << 32;
    long long key = LLONG_MIN;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + k;
      if (c <= Ls) {
        const long long kc = (long long)(c <= sl ? m[k] : kNeg) * kCol + c;
        key = key > kc ? key : kc;
      }
    }
    if (w == 0 && lane == 0) {
      const long long k0 = (long long)m0 * kCol;  // column 0 <= slen
      key = key > k0 ? key : k0;
    }
    key = warp_max64(key);
    if constexpr (kSeg) {
      __shared__ long long warp_best[kSegMaxWarps];
      if (lane == 0) warp_best[warp] = key;
      __syncthreads();
      key = warp_best[0];
      const int n = kClu ? block_warps() : nwb;
      for (int v = 1; v < n; ++v) key = warp_best[v] > key ? warp_best[v] : key;
    }
    if constexpr (kClu) {
      // each block's best into rank 0, which reduces them after the
      // cluster barrier below
      if (threadIdx.x == 0) st_cluster(dsmem_addr(&cta_best[cluster_ctarank()], 0), key);
    } else if (w == 0 && lane == 0) {
      write_free_end2(key, b, score_out, endj_out, startk_out);
    }
  } else {
    const int sc = min(max(sl, 0), Ls);  // callers keep slen <= Ls
    int mc = m0, ic = i0, dc = d0;
    bool mine = w == 0 && lane == 0 && sc == 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (c0 + k == sc) {
        mc = m[k]; ic = i[k]; dc = d[k];
        mine = true;
      }
    }
    if (mine) {
      int score = mc, sk = 0;
      if (ic > mc) { score = ic; sk = 1; }
      if (dc > score) score = dc;
      if (dc > max(mc, ic)) sk = 2;
      score_out[b] = score;
      endj_out[b] = sl;
      startk_out[b] = sk;
    }
  }
  if constexpr (kClu) {
    // no block leaves while a neighbour may still write into its shared
    // memory (the last done flags, the free_end2 bests)
    cluster_sync();
    if (!kFreeEnd1 && free_end2 && threadIdx.x == 0 && cluster_ctarank() == 0) {
      long long key = cta_best[0];
      const int n = (int)cluster_nctarank();
      for (int c = 1; c < n; ++c) key = cta_best[c] > key ? cta_best[c] : key;
      write_free_end2(key, b, score_out, endj_out, startk_out);
    }
  }
}

template <int K, bool kFreeStart1, bool kFreeEnd1>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
    gotoh_forward_warp_kernel(GOTOH_PARAMS) {
  gotoh_forward_rows<K, kWarpRows, kFreeStart1, kFreeEnd1>(GOTOH_FWD);
}

// blockDim.x = 32 * W; K * 33 * W ints of dynamic shared memory (the tiles)
template <int K, bool kFreeStart1, bool kFreeEnd1>
__global__ void __launch_bounds__(kSegMaxWarps * 32, 1)
    gotoh_forward_seg_kernel(GOTOH_PARAMS) {
  gotoh_forward_rows<K, kSegRows, kFreeStart1, kFreeEnd1>(GOTOH_FWD);
}

// launched as clusters of N blocks of nw warps (grid B * N); each block
// K * 33 * nw ints of dynamic shared memory (the tiles)
template <int K, bool kFreeStart1, bool kFreeEnd1>
__global__ void __launch_bounds__(kSegMaxWarps * 32, 1)
    gotoh_forward_cluster_kernel(GOTOH_PARAMS) {
  gotoh_forward_rows<K, kClusterRows, kFreeStart1, kFreeEnd1>(GOTOH_FWD);
}

// One alignment a block of nw warps.  free_end1 never takes more than
// kSegEnd1LaneCols columns a lane, so its wider variants are not built.
template <int K, bool kFreeStart1, bool kFreeEnd1>
cudaError_t launch_seg(int nw, cudaStream_t stream, GOTOH_PARAMS) {
  if constexpr (!kFreeEnd1 || K <= kSegEnd1LaneCols) {
    gotoh_forward_seg_kernel<K, kFreeStart1, kFreeEnd1>
        <<<B, nw * 32, (size_t)nw * K * 33 * sizeof(int), stream>>>(GOTOH_FWD);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

// The cluster kernel's launch: B clusters of n blocks of nw warps.
// `grid_clusters` is B for a launch, 1 for an occupancy query.
inline void cluster_config(cudaLaunchConfig_t* config, cudaLaunchAttribute* attr,
                           int grid_clusters, int n, int nw, int K, cudaStream_t stream) {
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(grid_clusters * n);
  config->blockDim = dim3(nw * 32);
  config->dynamicSmemBytes = (size_t)nw * K * 33 * sizeof(int);
  config->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
}

template <int K, bool kFreeStart1, bool kFreeEnd1>
cudaError_t launch_cluster(int n, int nw, cudaStream_t stream, GOTOH_PARAMS) {
  if constexpr (!kFreeEnd1 || K <= kClusterEnd1LaneCols) {
    cudaLaunchConfig_t config;
    cudaLaunchAttribute attr;
    cluster_config(&config, &attr, B, n, nw, K, stream);
    const cudaError_t rc = cudaLaunchKernelEx(
        &config, gotoh_forward_cluster_kernel<K, kFreeStart1, kFreeEnd1>, GOTOH_FWD);
    return rc != cudaSuccess ? rc : cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

template <int K, bool kFreeStart1, bool kFreeEnd1>
cudaError_t cluster_occupancy(int n, int nw, int* clusters) {
  if constexpr (!kFreeEnd1 || K <= kClusterEnd1LaneCols) {
    cudaLaunchConfig_t config;
    cudaLaunchAttribute attr;
    cluster_config(&config, &attr, 1, n, nw, K, nullptr);
    return cudaOccupancyMaxActiveClusters(
        clusters, gotoh_forward_cluster_kernel<K, kFreeStart1, kFreeEnd1>, &config);
  } else {
    return cudaErrorInvalidValue;
  }
}

// (warps a block, columns a lane) of a cluster of n blocks at Ls: the
// fewest warps, then the fewest columns a lane (kSegMinLaneCols up to
// `most`), such that every column is owned and every block owns one.
bool cluster_shape(int Ls, int most, int n, int* nw, int* lane_cols) {
  for (int v = 1; v <= kSegMaxWarps; ++v) {
    const int k = max(kSegMinLaneCols, (Ls + 32 * n * v - 1) / (32 * n * v));
    if (k <= most && 32 * k * v * (n - 1) < Ls) {
      *nw = v;
      *lane_cols = k;
      return true;
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// wide kernel (Ls > kClusterMaxLs): contiguous columns per thread, state in
// scratch

__device__ __forceinline__ int warp_incl_max(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, n);
  }
  return v;
}

// scratch fields of an owned column: committed previous-row state (M, I,
// D, CW = the run carries cwm | cwi), then this row's values between
// passes (new M, new I, new CW, y = A + ext*c)
enum { kFM, kFI, kFD, kFCW, kFNM, kFNI, kFNCW, kFY, kWideFields };
constexpr int kCwmMask = 0xFF03;    // sm | em<<8
constexpr int kCwiMask = 0xFF000C;  // si<<2 | ei<<16

// Block-wide exclusive max-scan over threadIdx.x order, seeded: thread t
// gets max(seed, v[0..t-1]).  Warp scans by shuffle, the warp totals
// scanned by warp 0 through `warp_tot` (32 ints); a thread takes its left
// lane's warp-inclusive value by shuffle and the earlier warps' total from
// warp_tot, between block barriers.
__device__ __forceinline__ int block_excl_max(int v, int seed, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int incl = warp_incl_max(v, lane);
  if (lane == 31) warp_tot[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int x = lane < nw ? warp_tot[lane] : INT_MIN;
    x = warp_incl_max(x, lane);
    if (lane < nw) warp_tot[lane] = x;
  }
  __syncthreads();
  const int up = __shfl_up_sync(0xffffffffu, incl, 1);
  const int prefix = wid > 0 ? warp_tot[wid - 1] : INT_MIN;  // earlier warps
  __syncthreads();
  return max(max(lane > 0 ? up : INT_MIN, prefix), seed);
}

// Thread t gets a and b of thread t-1 (thread 0 its own): a shuffle inside
// a warp, the previous warp's lane 31 through `slots` (2 x 32 ints).
__device__ __forceinline__ void block_from_left(int* a, int* b, int* slots) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 31) {
    slots[wid] = *a;
    slots[32 + wid] = *b;
  }
  __syncthreads();
  const int ua = __shfl_up_sync(0xffffffffu, *a, 1);
  const int ub = __shfl_up_sync(0xffffffffu, *b, 1);
  if (lane > 0) {
    *a = ua;
    *b = ub;
  } else if (wid > 0) {
    *a = slots[wid - 1];
    *b = slots[32 + wid - 1];
  }
  __syncthreads();
}

template <bool kFreeStart1, bool kFreeEnd1>
__global__ void __launch_bounds__(1024) gotoh_forward_wide_kernel(
    const int8_t* __restrict__ query, const int* __restrict__ qlen,
    const int8_t* __restrict__ subject, const int* __restrict__ slen,
    int* __restrict__ plane, int* __restrict__ score_out,
    int* __restrict__ endi_out, int* __restrict__ endj_out,
    int* __restrict__ startk_out,
    int B, int Lq, int Ls, int match, int mismatch, int open_gap,
    int ext_gap, int free_start2, int free_end2, int* __restrict__ scratch,
    int C) {
  __shared__ int warp_tot[32];
  __shared__ int slots[64];  // the diagonal hand-off between warps
  __shared__ long long warp_best[32];
  const int T = blockDim.x;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int c0 = t * C + 1;  // first owned column
  int* st = scratch + (size_t)b * kWideFields * C * T + t;
#define ST(f, k) st[((f) * C + (k)) * T]
  const int ql = qlen[b];
  const int sl = slen[b];
  const int8_t* srow = subject + (size_t)b * Ls;
  const int8_t* qrow = query + (size_t)b * Lq;

  for (int k = 0; k < C; ++k) {
    ST(kFM, k) = kNeg;
    ST(kFI, k) = kNeg;
    ST(kFD, k) = free_start2 ? 0 : -open_gap - ext_gap * (c0 + k - 1);
    ST(kFCW, k) = 0;
  }
  int m0 = 0, i0 = 0, d0 = 0;  // column 0 (its run carries stay 0)
  // free_end1: running best M[r][sl] of the thread that owns column sl,
  // as in the warp kernel
  int best = sl == 0 ? 0 : kNeg;
  int brow = sl == 0 ? 0 : Lq;
  const size_t row_stride = (size_t)B * Ls;
  int* prow = plane + (size_t)b * Ls;
  const int neg_mismatch = -mismatch;

  for (int r = 1; r <= Lq; ++r) {
    const int q = qrow[r - 1];
    const bool active = r <= ql;  // block-uniform
    const int i0n = kFreeStart1 ? 0 : -open_gap - ext_gap * (r - 1);
    const int am0 = kNeg - open_gap;
    const int ai0 = i0n - open_gap;
    const int a0 = max(am0, ai0);

    // diagonal hand-off of the left neighbour's last column's committed
    // state; thread 0 takes column 0's
    int hd_in, mw_in;
    diag_out(ST(kFM, C - 1), ST(kFI, C - 1), ST(kFD, C - 1),
             ST(kFCW, C - 1) & kCwmMask, &hd_in, &mw_in);
    block_from_left(&hd_in, &mw_in, slots);
    if (t == 0) diag_out(m0, i0, d0, 0, &hd_in, &mw_in);

    // pass 1: M, I, their carries and y = A + ext*c; the thread's max of y
    int run = INT_MIN;
    for (int k = 0; k < C; ++k) {
      const int c = c0 + k;
      const int m = ST(kFM, k), i = ST(kFI, k), d = ST(kFD, k);
      const int cw = ST(kFCW, k);
      const int s_ch = c <= Ls ? srow[c - 1] : 0;
      const int m_row = hd_in + (s_ch == q ? match : neg_mismatch);
      const int cm = m - open_gap, ci = i - ext_gap, cd = d - open_gap;
      bool ci_ge_cd, cm_ge, m_ge_i;
      const int mx = max_ge(ci, cd, &ci_ge_cd);
      const int i_row = max_ge(cm, mx, &cm_ge);
      const int cwi = cw & kCwiMask;
      const int grown = min(cwi + 0x10000, cwi | 0xFF0000);
      const int cwi_row = cm_ge ? 0x10000 : (ci_ge_cd ? grown : 0x10008);
      const int y = max_ge(m_row, i_row, &m_ge_i) - open_gap + ext_gap * c;
      run = max(run, y);
      ST(kFNM, k) = m_row;
      ST(kFNI, k) = i_row;
      ST(kFNCW, k) = mw_in | cwi_row;
      ST(kFY, k) = y;
      diag_out(m, i, d, cw & kCwmMask, &hd_in, &mw_in);  // for column c+1
    }
    // scan 1: pre = max(a0, y of every column left of the thread's first)
    const int pre = block_excl_max(run, a0, warp_tot);

    // pass 2: the thread's max of z (packed D-open source, -1 if none)
    int zr = -1, left = pre;
    for (int k = 0; k < C; ++k) {
      const int c = c0 + k;
      const int y = ST(kFY, k);
      const bool m_ge_i = ST(kFNM, k) >= ST(kFNI, k);
      const int z = y >= left ? (c + 1) * 4 + (m_ge_i ? 0 : 1) : -1;
      zr = max(zr, z);
      left = max(left, y);
    }
    // scan 2, seeded by column 0 (its D is banned, so column 1 opens
    // unless a0 is banned too)
    const int z0 = a0 >= kNeg - ext_gap ? 4 + (am0 >= ai0 ? 0 : 1) : -1;
    const int zpre = block_excl_max(zr, max(z0, 0), warp_tot);

    // pass 3: D, the plane word, and the commit of an active row
    left = pre;
    int orun = zpre;
    for (int k = 0; k < C; ++k) {
      const int c = c0 + k;
      const int y = ST(kFY, k);
      const int nm = ST(kFNM, k), ni = ST(kFNI, k);
      const int d_row = left - ext_gap * (c - 1);
      const int z = y >= left ? (c + 1) * 4 + (nm >= ni ? 0 : 1) : -1;
      const int sd = orun & 3;
      const int ed = min(c - (orun >> 2) + 1, 255);
      const int ncw = ST(kFNCW, k);
      const int cw = active ? ncw : ST(kFCW, k);
      if (c <= Ls) prow[c - 1] = cw | (sd << 4) | (ed << 24);
      if (active) {
        ST(kFM, k) = nm;
        ST(kFI, k) = ni;
        ST(kFD, k) = d_row;
        ST(kFCW, k) = ncw;
        if (kFreeEnd1 && c == sl && nm >= best) {
          best = nm;
          brow = r;
        }
      }
      left = max(left, y);
      orun = max(orun, z);
    }
    if (active) {
      m0 = kNeg;
      i0 = i0n;
      d0 = kNeg;
    }
    prow += row_stride;
  }

  const int own = sl - c0;  // index of column sl among the owned columns
  if (kFreeEnd1) {
    if ((own >= 0 && own < C) || (sl == 0 && t == 0)) {
      score_out[b] = best;
      endi_out[b] = brow;
      endj_out[b] = sl;
      startk_out[b] = 0;
    }
    return;
  }
  if (free_end2) {
    // best M over columns 0..Ls, ties to the largest column
    constexpr long long kCol = 1LL << 32;
    long long key = LLONG_MIN;
    for (int k = 0; k < C; ++k) {
      const int c = c0 + k;
      if (c <= Ls) {
        const long long kc = (long long)(c <= sl ? ST(kFM, k) : kNeg) * kCol + c;
        key = key > kc ? key : kc;
      }
    }
    if (t == 0) {
      const long long k0 = (long long)m0 * kCol;  // column 0 <= slen
      key = key > k0 ? key : k0;
    }
    key = warp_max64(key);
    if ((t & 31) == 0) warp_best[t >> 5] = key;
    __syncthreads();
    if (t == 0) {
      long long bk = warp_best[0];
      for (int w = 1; w < T / 32; ++w) bk = warp_best[w] > bk ? warp_best[w] : bk;
      const int ej = (int)(bk & 0xffffffffLL);
      score_out[b] = (int)((bk - ej) / kCol);
      endj_out[b] = ej;
      startk_out[b] = 0;
    }
  } else {
    const int sc = min(max(sl, 0), Ls);  // callers keep slen <= Ls
    const int ko = sc - c0;
    const bool mine = sc == 0 ? t == 0 : (ko >= 0 && ko < C);
    if (mine) {
      const int mc = sc == 0 ? m0 : ST(kFM, ko);
      const int ic = sc == 0 ? i0 : ST(kFI, ko);
      const int dc = sc == 0 ? d0 : ST(kFD, ko);
      int score = mc, sk = 0;
      if (ic > mc) { score = ic; sk = 1; }
      if (dc > score) score = dc;
      if (dc > max(mc, ic)) sk = 2;
      score_out[b] = score;
      endj_out[b] = sl;
      startk_out[b] = sk;
    }
  }
#undef ST
}

#undef GOTOH_FWD
#undef GOTOH_PARAMS
#define GOTOH_ARGS                                                          \
  (const int8_t*)query, (const int*)qlen, (const int8_t*)subject,           \
      (const int*)slen, (int*)plane, (int*)score, (int*)end_i, (int*)end_j, \
      (int*)start_k, B, Lq, Ls, match, mismatch, open_gap, ext_gap,         \
      free_start2, free_end2
// picks the <.., kFreeStart1, kFreeEnd1> instantiation of a launch
#define GOTOH_BY_QUERY_ENDS(LAUNCH)                                         \
  if (free_start1 && free_end1) { LAUNCH(true, true); }                     \
  else if (free_start1) { LAUNCH(true, false); }                            \
  else if (free_end1) { LAUNCH(false, true); }                              \
  else { LAUNCH(false, false); }

// clusters of n blocks of nw warps of the cluster kernel's <lane_cols,
// free_start1, free_end1> variant that the device holds at once
// (cudaOccupancyMaxActiveClusters)
cudaError_t query_occupancy(int n, int nw, int lane_cols, int free_start1, int free_end1,
                            int* out) {
#define GOTOH_OCC(FS1, FE1) return cluster_occupancy<KK, FS1, FE1>(n, nw, out)
#define GOTOH_OCC_CASE(K)                                                   \
  case K: {                                                                 \
    constexpr int KK = K;                                                   \
    GOTOH_BY_QUERY_ENDS(GOTOH_OCC)                                          \
    break;                                                                  \
  }
  switch (lane_cols) {
    GOTOH_OCC_CASE(4)
    GOTOH_OCC_CASE(5)
    GOTOH_OCC_CASE(6)
    GOTOH_OCC_CASE(7)
    GOTOH_OCC_CASE(8)
  }
#undef GOTOH_OCC_CASE
#undef GOTOH_OCC
  return cudaErrorInvalidValue;
}

// query_occupancy on the current device, asked once a device and layout;
// 0 where the layout does not fit
int clusters_held(int n, int nw, int lane_cols, int free_start1, int free_end1) {
  constexpr int kDevices = 16;
  // held + 1 by device, K, query ends, n, nw; 0: not asked yet
  static int cache[kDevices][kMaxLaneCols - kSegMinLaneCols + 1][4][kClusterMaxCtas]
                  [kSegMaxWarps];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int* slot = dev < kDevices ? &cache[dev][lane_cols - kSegMinLaneCols]
                                     [free_start1 * 2 + free_end1][n - 1][nw - 1]
                             : nullptr;
  if (slot && *slot) return *slot - 1;
  int held = 0;
  if (query_occupancy(n, nw, lane_cols, free_start1, free_end1, &held) != cudaSuccess) {
    cudaGetLastError();  // not an error of the next launch
    held = 0;
  }
  if (slot) *slot = held + 1;
  return held;
}

// The cluster kernel's layout (kernels/pairwise_cuda.py:cluster_layout):
// over cluster sizes n = 1..8 (or `ctas` alone), each with cluster_shape's
// (nw, k), the least time of the busiest SM: the B clusters run in
// ceil(B / held) waves of the `held` the card holds at once, a wave puts
// ceil(min(B, held) * n / n_sms) blocks on an SM, and a block's row costs
// k * (3 * nw + 4) (k columns a lane on nw warps and a fixed 4/3 of a
// warp's row: measured); then the fewest blocks a cluster.
bool cluster_layout(int B, int Ls, int free_start1, int free_end1, int n_sms, int ctas,
                    int* n, int* nw, int* lane_cols) {
  const int most = free_end1 ? kClusterEnd1LaneCols : kMaxLaneCols;
  long long best = -1;
  for (int c = ctas ? ctas : 1; c <= (ctas ? ctas : kClusterMaxCtas); ++c) {
    int v, k;
    if (!cluster_shape(Ls, most, c, &v, &k)) continue;
    const long long held = clusters_held(c, v, k, free_start1, free_end1);
    if (held <= 0) continue;
    const long long wave = B < held ? B : held;
    const long long cost =
        (B + held - 1) / held * ((wave * c + n_sms - 1) / n_sms) * k * (3 * v + 4);
    if (best < 0 || cost < best) {
      best = cost;
      *n = c;
      *nw = v;
      *lane_cols = k;
    }
  }
  return best >= 0;
}

}  // namespace

// Launches the warp-per-alignment kernel for Ls <= 256, the seg kernel for
// 256 < Ls <= kSegMaxLs, the cluster kernel for kSegMaxLs < Ls <=
// kClusterMaxLs and the wide kernel above.  `kernel & 0xFF` 1 asks for the
// seg kernel at any Ls <= kSegMaxLs, 2 for the wide kernel at any Ls and 3
// for the cluster kernel (to check them at narrow shapes); `kernel >> 8`,
// when not 0, is the cluster kernel's blocks a cluster.  The seg kernel
// takes the fewest warps of at most kMaxLaneCols columns a lane
// (kSegEnd1LaneCols with free_end1), then the fewest columns a lane, at
// least kSegMinLaneCols (kernels/pairwise_cuda.py:seg_layout); the cluster
// kernel the layout of cluster_layout on this device's SMs.
// `scratch` holds B * 8 * C * threads ints for the wide kernel, with C =
// ceil(Ls/1024) and threads = ceil(ceil(Ls/C)/32)*32
// (kernels/pairwise_cuda.py:wide_layout); the others ignore it.  The four
// free-end flags are those of the plain version; free_end1 with free_end2
// is refused.
extern "C" int gotoh_forward_launch(
    const void* query, const void* qlen, const void* subject,
    const void* slen, void* plane, void* score, void* end_i, void* end_j,
    void* start_k, int B, int Lq, int Ls, int match, int mismatch,
    int open_gap, int ext_gap, int free_start1, int free_end1,
    int free_start2, int free_end2, int kernel, void* scratch,
    void* stream_ptr) {
  const int code = kernel & 0xFF;
  const int ctas = kernel >> 8;
  if (B <= 0 || Lq <= 0) return (int)cudaGetLastError();
  if (Ls < 1 || code > 3 || (code == 1 && Ls > kSegMaxLs) || ctas < 0 ||
      ctas > kClusterMaxCtas)
    return (int)cudaErrorInvalidValue;
  if (free_end1 && free_end2) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (code == 3 || (code == 0 && Ls > kSegMaxLs && Ls <= kClusterMaxLs)) {
    int dev = 0, n_sms = 0, n = 0, nw = 0, lane_cols = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    if (!cluster_layout(B, Ls, free_start1, free_end1, n_sms, ctas, &n, &nw, &lane_cols))
      return (int)cudaErrorInvalidValue;
#define GOTOH_CLUSTER(FS1, FE1) \
  return (int)launch_cluster<KK, FS1, FE1>(n, nw, stream, GOTOH_ARGS)
#define GOTOH_CLUSTER_CASE(K)                                               \
  case K: {                                                                 \
    constexpr int KK = K;                                                   \
    GOTOH_BY_QUERY_ENDS(GOTOH_CLUSTER)                                      \
    break;                                                                  \
  }
    switch (lane_cols) {
      GOTOH_CLUSTER_CASE(4)
      GOTOH_CLUSTER_CASE(5)
      GOTOH_CLUSTER_CASE(6)
      GOTOH_CLUSTER_CASE(7)
      GOTOH_CLUSTER_CASE(8)
    }
#undef GOTOH_CLUSTER_CASE
#undef GOTOH_CLUSTER
    return (int)cudaErrorInvalidValue;
  }
  if (code == 2 || (code == 0 && Ls > kSegMaxLs)) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int C = (Ls + 1023) / 1024;
    const int threads = (((Ls + C - 1) / C + 31) / 32) * 32;
#define GOTOH_WIDE(FS1, FE1)                                              \
  gotoh_forward_wide_kernel<FS1, FE1><<<B, threads, 0, stream>>>(GOTOH_ARGS, \
                                                                 (int*)scratch, C)
    GOTOH_BY_QUERY_ENDS(GOTOH_WIDE)
#undef GOTOH_WIDE
    return (int)cudaGetLastError();
  }
  if (code == 1 || Ls > 32 * kMaxLaneCols) {
    const int most = free_end1 ? kSegEnd1LaneCols : kMaxLaneCols;
    const int nw = (Ls + 32 * most - 1) / (32 * most);
    const int lane_cols = max(kSegMinLaneCols, (Ls + 32 * nw - 1) / (32 * nw));
#define GOTOH_SEG(FS1, FE1) \
  return (int)launch_seg<KK, FS1, FE1>(nw, stream, GOTOH_ARGS)
#define GOTOH_SEG_CASE(K)                                                   \
  case K: {                                                                 \
    constexpr int KK = K;                                                   \
    GOTOH_BY_QUERY_ENDS(GOTOH_SEG)                                          \
    break;                                                                  \
  }
    switch (lane_cols) {
      GOTOH_SEG_CASE(4)
      GOTOH_SEG_CASE(5)
      GOTOH_SEG_CASE(6)
      GOTOH_SEG_CASE(7)
      GOTOH_SEG_CASE(8)
    }
#undef GOTOH_SEG_CASE
#undef GOTOH_SEG
    return (int)cudaGetLastError();
  }
  const int blocks = (B + kWarps - 1) / kWarps;
#define GOTOH_WARP(FS1, FE1)         \
  gotoh_forward_warp_kernel<KK, FS1, FE1> \
      <<<blocks, kWarps * 32, 0, stream>>>(GOTOH_ARGS)
#define GOTOH_WARP_CASE(K)                                                  \
  case K: {                                                                 \
    constexpr int KK = K;                                                   \
    GOTOH_BY_QUERY_ENDS(GOTOH_WARP)                                         \
    break;                                                                  \
  }
  switch ((Ls + 31) / 32) {
    GOTOH_WARP_CASE(1)
    GOTOH_WARP_CASE(2)
    GOTOH_WARP_CASE(3)
    GOTOH_WARP_CASE(4)
    GOTOH_WARP_CASE(5)
    GOTOH_WARP_CASE(6)
    GOTOH_WARP_CASE(7)
    GOTOH_WARP_CASE(8)
  }
#undef GOTOH_WARP_CASE
#undef GOTOH_WARP
#undef GOTOH_ARGS
#undef GOTOH_BY_QUERY_ENDS
  return (int)cudaGetLastError();
}

// The clusters of the cluster kernel's <lane_cols, free_start1, free_end1>
// variant in clusters of n blocks of nw warps that the device holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int gotoh_cluster_occupancy(int n, int nw, int lane_cols, int free_start1,
                                       int free_end1, void* clusters) {
  if (n < 1 || n > kClusterMaxCtas || nw < 1 || nw > kSegMaxWarps)
    return (int)cudaErrorInvalidValue;
  return (int)query_occupancy(n, nw, lane_cols, free_start1, free_end1, (int*)clusters);
}
