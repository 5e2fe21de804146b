// K2: stable two-way partition of a row window, for Hopper (sm_90a).
//
// Replaces: lightgbm_tpu/ops/partition_kernel.py, route_pair /
// _route_pair_kernel (the Pallas TPU butterfly router), and takes the place
// of the variadic sort in the JAX compact grower's part_apply. Rows of a
// leaf's contiguous window whose split decision is "left" move to the front
// of the same window in the other buffer of a ping-pong pair, the others to
// the back, each side in its original order:
//   left  row -> dst[nl_before + rank]
//   right row -> dst[n_left + nr_before + rank]
// A row is its F bins (u8/u16), optionally its payload and its int32 row
// id. The payload is the row's (grad, hess) pair: 8 bytes (an f32 pair) on
// the float path, 2 bytes (an int8 pair, moved as one 16-bit word) on the
// quantized path, as the JAX grower packs the int8 pair into one u16 sort
// column. The decision is the numerical split rule of the JAX
// grower (ops/grow.py chunk_goleft): the NaN bin follows default_left,
// every other bin goes left when bin <= threshold_bin.
//
// What bounds it on the H100: bytes. The window is read once to decide
// (pass 1), once more to move (pass 3), and written once: about
// cnt * (F + 4 + payload bytes) bytes each way (F + 12 on the float path,
// F + 6 on the quantized one). The shape is that of
// LightGBM's CUDA learner (cuda_data_partition.cu: GenDataToLeftBitVector +
// SplitInner), not the TPU butterfly, which exists only because a TPU has
// no per-lane scatter:
// - pass 1 (part_count): each block evaluates the rule for its tile of
//   rows and counts its lefts;
// - pass 2 (part_scan): one block turns the per-block counts into
//   exclusive offsets and writes the window's n_left to device memory;
// - pass 3 (part_scatter): each block re-evaluates its rows in row order,
//   ranks them stably with __ballot_sync + __popc and a scan over the
//   block's warps, and writes every row to its destination.
// The result is a permutation, so it is bit-exact against the plain
// version.
//
// Design limits (what a later PR redesigns): three passes and the second
// read of the window, where a single-pass decoupled look-back scan would
// read it once; rows are copied by whole 4-byte words only when a row's
// bytes are a multiple of 4, else element by element; and the one-block
// scan of pass 2 is serial over up to ~10k block counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;  // rows per block
constexpr int kScanThreads = 1024;

template <typename BinT>
__device__ __forceinline__ bool go_left(const BinT* row, int f, int t, int dl,
                                        int nan_bin) {
  const int v = (int)row[f];
  return (nan_bin >= 0 && v == nan_bin) ? (dl != 0) : (v <= t);
}

template <typename BinT>
__global__ void part_count(const BinT* __restrict__ bins, long long cnt,
                           int F, int f, int t, int dl, int nan_bin,
                           int* __restrict__ block_counts) {
  __shared__ int warp_sums[kThreads / 32];
  const long long base = (long long)blockIdx.x * kTile;
  int c = 0;
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long r = base + k * kThreads + threadIdx.x;
    if (r < cnt && go_left(bins + r * F, f, t, dl, nan_bin)) ++c;
  }
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    block_counts[blockIdx.x] = s;
  }
}

// in place: counts -> exclusive offsets; *n_left_out = the total
__global__ void part_scan(int* __restrict__ block_counts, int nblocks,
                          int* __restrict__ n_left_out) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int per = (nblocks + kScanThreads - 1) / kScanThreads;
  const int beg = min(nblocks, (int)threadIdx.x * per);
  const int end = min(nblocks, beg + per);
  int local = 0;
  for (int i = beg; i < end; ++i) local += block_counts[i];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = local;  // inclusive scan within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const int excl = x - local + (warp > 0 ? warp_sums[warp - 1] : 0);
  int run = excl;
  for (int i = beg; i < end; ++i) {
    const int v = block_counts[i];
    block_counts[i] = run;
    run += v;
  }
  if (threadIdx.x == kScanThreads - 1) *n_left_out = run;
}

template <typename BinT>
__global__ void part_scatter(const BinT* __restrict__ bins_src,
                             BinT* __restrict__ bins_dst,
                             const void* __restrict__ pay_src,
                             void* __restrict__ pay_dst, int pay_bytes,
                             const int* __restrict__ ids_src,
                             int* __restrict__ ids_dst, long long cnt, int F,
                             int f, int t, int dl, int nan_bin,
                             const int* __restrict__ block_offsets,
                             const int* __restrict__ n_left_ptr,
                             int row_words) {
  __shared__ int warp_tot[kThreads / 32];
  const long long n_left = *n_left_ptr;
  const long long base = (long long)blockIdx.x * kTile;
  long long lefts_before = block_offsets[blockIdx.x];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 0; k < kRowsPerThread; ++k) {
    // round k covers rows [base + k*kThreads, base + (k+1)*kThreads) in
    // thread order, so lane/warp order is row order: the ranks are stable
    const long long r = base + k * kThreads + threadIdx.x;
    const bool valid = r < cnt;
    const bool gl = valid && go_left(bins_src + r * F, f, t, dl, nan_bin);
    const unsigned ball = __ballot_sync(0xffffffffu, gl);
    const int rank = __popc(ball & ((1u << lane) - 1u));
    if (lane == 0) warp_tot[warp] = __popc(ball);
    __syncthreads();
    int warp_off = 0;
    int round_tot = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const int v = warp_tot[w];
      if (w < warp) warp_off += v;
      round_tot += v;
    }
    if (valid) {
      const long long lb = lefts_before + warp_off + rank;
      const long long dst = gl ? lb : n_left + (r - lb);
      if (row_words > 0) {
        const uint32_t* s = reinterpret_cast<const uint32_t*>(bins_src) +
                            r * row_words;
        uint32_t* d = reinterpret_cast<uint32_t*>(bins_dst) + dst * row_words;
        for (int j = 0; j < row_words; ++j) d[j] = s[j];
      } else {
        const BinT* s = bins_src + r * F;
        BinT* d = bins_dst + dst * F;
        for (int j = 0; j < F; ++j) d[j] = s[j];
      }
      if (pay_bytes == 8)
        static_cast<float2*>(pay_dst)[dst] =
            static_cast<const float2*>(pay_src)[r];
      else if (pay_bytes == 2)
        static_cast<uint16_t*>(pay_dst)[dst] =
            static_cast<const uint16_t*>(pay_src)[r];
      if (ids_src != nullptr) ids_dst[dst] = ids_src[r];
    }
    lefts_before += round_tot;
    __syncthreads();  // warp_tot is rewritten by the next round
  }
}

template <typename BinT>
cudaError_t launch(const void* bins_src, void* bins_dst, const void* pay_src,
                   void* pay_dst, int pay_bytes, const void* ids_src,
                   void* ids_dst,
                   long long cnt, int F, int f, int t, int dl, int nan_bin,
                   int* scratch, int nblocks, int* n_left,
                   cudaStream_t stream) {
  const BinT* bs = static_cast<const BinT*>(bins_src);
  BinT* bd = static_cast<BinT*>(bins_dst);
  part_count<BinT><<<nblocks, kThreads, 0, stream>>>(bs, cnt, F, f, t, dl,
                                                     nan_bin, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  part_scan<<<1, kScanThreads, 0, stream>>>(scratch, nblocks, n_left);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t row_bytes = (size_t)F * sizeof(BinT);
  const bool aligned =
      row_bytes % 4 == 0 && reinterpret_cast<uintptr_t>(bins_src) % 4 == 0 &&
      reinterpret_cast<uintptr_t>(bins_dst) % 4 == 0;
  const int row_words = aligned ? (int)(row_bytes / 4) : 0;
  part_scatter<BinT><<<nblocks, kThreads, 0, stream>>>(
      bs, bd, pay_src, pay_dst, pay_bytes, static_cast<const int*>(ids_src),
      static_cast<int*>(ids_dst), cnt, F, f, t, dl, nan_bin, scratch, n_left,
      row_words);
  return cudaGetLastError();
}

}  // namespace

extern "C" int partition_tile_rows() { return kTile; }

// Partition the window [0, cnt) of the source pointers into the
// destination pointers (each already offset to the window's first row).
// `scratch` holds ceil(cnt / partition_tile_rows()) ints; `n_left` one int.
// pay_bytes is a payload row's width: 8 (f32 pair), 2 (int8 pair) or 0 (no
// payload; pay_* are then ignored). ids_* may be null. Returns the first
// CUDA error (0 = success).
extern "C" int partition_window(const void* bins_src, void* bins_dst,
                                int bin_bytes, const void* pay_src,
                                void* pay_dst, int pay_bytes,
                                const void* ids_src,
                                void* ids_dst, long long cnt, int F, int f,
                                int t, int dl, int nan_bin, void* scratch,
                                int scratch_len, void* n_left, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* nl = static_cast<int*>(n_left);
  if (cnt <= 0) return (int)cudaMemsetAsync(nl, 0, sizeof(int), s);
  const long long nb = (cnt + kTile - 1) / kTile;
  if (nb > scratch_len || nb > 0x7fffffffLL || f < 0 || f >= F ||
      (pay_bytes != 0 && pay_bytes != 2 && pay_bytes != 8) ||
      (pay_bytes != 0 && (pay_src == nullptr || pay_dst == nullptr)))
    return (int)cudaErrorInvalidValue;
  int* sc = static_cast<int*>(scratch);
  if (bin_bytes == 1)
    return (int)launch<uint8_t>(bins_src, bins_dst, pay_src, pay_dst,
                                pay_bytes, ids_src, ids_dst, cnt, F, f, t,
                                dl, nan_bin, sc, (int)nb, nl, s);
  if (bin_bytes == 2)
    return (int)launch<uint16_t>(bins_src, bins_dst, pay_src, pay_dst,
                                 pay_bytes, ids_src, ids_dst, cnt, F, f, t,
                                 dl, nan_bin, sc, (int)nb, nl, s);
  return (int)cudaErrorInvalidValue;
}
