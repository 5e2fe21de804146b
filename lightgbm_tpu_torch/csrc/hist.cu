// K1: gradient/hessian histogram of a row window, for Hopper (sm_90a).
//
// Replaces: lightgbm_tpu/ops/pallas_hist.py, _hist_tiles / _hist_kernel
// (the Pallas TPU kernel behind hist_from_rows_pallas), both of its paths:
//   out[f, b, c] = sum_s payload[s, c] * [rows[s, f] == b]
// over a contiguous window of a row-major [n, F] u8/u16 bin matrix and its
// [n, 2] payload:
// - float path: f32 (grad, hess) payload -> f32 histogram;
// - int path (int_exact=True in the TPU kernel, quantized-gradient
//   training): int8 (grad, hess) payload -> exact int32 histogram.
//
// What bounds it on the H100: bytes. Each row is read once (F bin bytes +
// 8 payload bytes, or 2 on the int path); the arithmetic is one add per
// (row, feature, channel). The TPU design (a one-hot times payload
// contraction on the MXU, with f32 super-blocks of at most 131072 rows on
// the int path so that f32 sums stay exact) has no reason to exist here:
// on Hopper this is a scatter into a small table, and the int path
// accumulates int32 directly.
//
// Design, shared by both paths:
// - each block takes a contiguous range of the window and keeps a private
//   [Fg, B, 2] histogram (f32 or int32) in dynamic shared memory (28
//   features x 255 bins x 2 x 4 B = 57 KB at the Higgs shape). Rows are
//   staged tile by tile into shared memory with coalesced loads;
// - each block writes its partial histogram to a [nblocks, F, B, 2]
//   scratch, and hist_reduce_kernel sums the partials in block order.
//
// Float path (hist_partial_kernel): each warp owns a fixed set of
// features of the block's table, so no two warps ever write the same
// shared address. Within a warp the 32 lanes take 32 consecutive rows of
// one feature. Lanes that hit the same bin are grouped with
// __match_any_sync and ranked within their group; the warp adds to the
// table in rounds, round k taking the rank-k lanes, so no two lanes of a
// round touch one address and each bin takes its rows in ascending lane
// order. There are no atomics at all, so every sum is taken in one fixed
// order: the result is bit-identical from run to run (float atomics would
// let the order change and flip near-tied splits).
//
// Int path (hist_partial_int_kernel): integer addition is associative, so
// the order does not matter and the result is exact and bit-identical in
// any order. The block's threads therefore walk the staged tile's
// (row, feature) elements flat, consecutive threads on consecutive
// features (so one warp's adds spread over many features' tables), and add
// with shared-memory int32 atomicAdd (native on Hopper); a zero payload
// channel adds nothing and is skipped. Partials and the reduce are int32.
// Range: a block's partial holds at most rows_per_block * 127 and the
// window's sum at most cnt * 127 in magnitude, so int32 is exact for
// windows of up to 2^31 / 127 (16.9M) rows at any int8 payload.
//
// The window is [start, start + cnt) for side 0; for side 1 and 2 it is the
// left or right child of a partitioned window whose left count n_left lies
// in device memory (written by K2), so the grower needs no host read-back
// between the partition and the child histogram.
//
// Design limits (what a later PR redesigns): on the float path a hot bin
// serialises the warp into as many rounds as lanes share it (up to 32), and
// a warp owns whole features, so at F = 28 over 8 warps the load is uneven
// (4 vs 3 features); on the int path a hot bin serialises its shared
// atomics the same way; on both, every block writes a full partial table
// and the reduce pass re-reads them, and there is no TMA/cp.async double
// buffering of the row tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Window {
  long long start;
  long long cnt;
};

__device__ __forceinline__ Window resolve_window(int start, int cnt,
                                                 const int* n_left, int side) {
  Window w;
  if (side == 0) {
    w.start = start;
    w.cnt = cnt;
  } else {
    const long long nl = *n_left;
    if (side == 1) {
      w.start = start;
      w.cnt = nl;
    } else {
      w.start = start + nl;
      w.cnt = cnt - nl;
    }
  }
  return w;
}

// Stage rows [t0, t0 + tr) of features [f0, f0 + fg) of the window into
// tbins ([tr, fg], row-major), and their payload pairs into tpay.
template <typename BinT, typename PayT>
__device__ __forceinline__ void stage_tile(const BinT* wbins,
                                           const PayT* wpay, long long t0,
                                           int tr, int F, int f0, int fg,
                                           BinT* tbins, PayT* tpay) {
  if (fg == F) {
    // the tile is one contiguous byte range: copy it by 4-byte words
    // when it is aligned (u8 rows of 28 features always are)
    const BinT* src = wbins + t0 * F;
    const size_t nbytes = (size_t)tr * F * sizeof(BinT);
    if ((reinterpret_cast<uintptr_t>(src) & 3) == 0 && (nbytes & 3) == 0) {
      const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src);
      uint32_t* d4 = reinterpret_cast<uint32_t*>(tbins);
      for (int i = threadIdx.x; i < (int)(nbytes >> 2); i += blockDim.x)
        d4[i] = s4[i];
    } else {
      for (int i = threadIdx.x; i < tr * F; i += blockDim.x)
        tbins[i] = src[i];
    }
  } else {
    for (int i = threadIdx.x; i < tr * fg; i += blockDim.x) {
      const int r = i / fg;
      const int c = i - r * fg;
      tbins[i] = wbins[(t0 + r) * F + f0 + c];
    }
  }
  const PayT* psrc = wpay + t0 * 2;
  if constexpr (sizeof(PayT) == 1) {
    // an int8 pair is one 2-byte word (rows start 2-byte aligned)
    const uint16_t* s2 = reinterpret_cast<const uint16_t*>(psrc);
    uint16_t* d2 = reinterpret_cast<uint16_t*>(tpay);
    for (int i = threadIdx.x; i < tr; i += blockDim.x) d2[i] = s2[i];
  } else {
    for (int i = threadIdx.x; i < tr * 2; i += blockDim.x) tpay[i] = psrc[i];
  }
}

// Shared-memory layout of both partial kernels: the [Fg, B, 2] table, the
// [tile, 2] payload, then the [tile, Fg] bins.
template <typename BinT, typename PayT, typename AccT>
__host__ __device__ __forceinline__ size_t smem_bytes(int Fg, int B,
                                                      int tile_rows) {
  return (size_t)Fg * B * 2 * sizeof(AccT) +
         (size_t)tile_rows * 2 * sizeof(PayT) +
         (size_t)tile_rows * Fg * sizeof(BinT);
}

template <typename BinT>
__global__ void hist_partial_kernel(const BinT* __restrict__ bins,
                                    const float* __restrict__ pay, int start,
                                    int cnt, const int* __restrict__ n_left,
                                    int side, int F, int B, int Fg,
                                    int tile_rows, int rows_per_block,
                                    float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hist = reinterpret_cast<float*>(smem);              // [Fg, B, 2]
  float* tpay = hist + (size_t)Fg * B * 2;                   // [tile, 2]
  BinT* tbins = reinterpret_cast<BinT*>(tpay + (size_t)tile_rows * 2);

  const Window w = resolve_window(start, cnt, n_left, side);
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  if (r0 >= w.cnt) return;  // the reduce pass never reads this partial
  const long long r1 = min(w.cnt, r0 + rows_per_block);
  const int f0 = blockIdx.y * Fg;
  const int fg = min(Fg, F - f0);
  const int nh = fg * B * 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = threadIdx.x; i < nh; i += blockDim.x) hist[i] = 0.f;

  const BinT* wbins = bins + w.start * F;
  const float* wpay = pay + w.start * 2;
  for (long long t0 = r0; t0 < r1; t0 += tile_rows) {
    const int tr = (int)min((long long)tile_rows, r1 - t0);
    __syncthreads();  // the table is zeroed / the previous tile is consumed
    stage_tile(wbins, wpay, t0, tr, F, f0, fg, tbins, tpay);
    __syncthreads();
    for (int fl = warp; fl < fg; fl += nwarps) {
      float* hf = hist + (size_t)fl * B * 2;
      for (int rb = 0; rb < tr; rb += 32) {
        const int r = rb + lane;
        const bool valid = r < tr;
        const int b = valid ? (int)tbins[r * fg + fl] : 0;
        const float g = valid ? tpay[2 * r] : 0.f;
        const float h = valid ? tpay[2 * r + 1] : 0.f;
        // lanes past the tile get keys no bin can take: singleton groups
        const int key = valid ? b : -1 - lane;
        const unsigned grp = __match_any_sync(0xffffffffu, key);
        // a lane's rank among the lanes that share its bin; round k adds
        // the rank-k lanes, so within a round no two lanes touch one
        // address and a bin takes its rows in ascending lane order
        const int rank = __popc(grp & ((1u << lane) - 1u));
        const int rounds = __reduce_max_sync(0xffffffffu, rank);
        const bool add = valid && b < B;
        for (int k = 0; k <= rounds; ++k) {
          if (add && rank == k) {
            hf[2 * b] += g;
            hf[2 * b + 1] += h;
          }
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();
  float* out = partials + ((size_t)blockIdx.x * F + f0) * B * 2;
  for (int i = threadIdx.x; i < nh; i += blockDim.x) out[i] = hist[i];
}

template <typename BinT>
__global__ void hist_partial_int_kernel(const BinT* __restrict__ bins,
                                        const int8_t* __restrict__ pay,
                                        int start, int cnt,
                                        const int* __restrict__ n_left,
                                        int side, int F, int B, int Fg,
                                        int tile_rows, int rows_per_block,
                                        int* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hist = reinterpret_cast<int*>(smem);                  // [Fg, B, 2]
  int8_t* tpay = reinterpret_cast<int8_t*>(hist + (size_t)Fg * B * 2);
  BinT* tbins = reinterpret_cast<BinT*>(tpay + (size_t)tile_rows * 2);

  const Window w = resolve_window(start, cnt, n_left, side);
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  if (r0 >= w.cnt) return;  // the reduce pass never reads this partial
  const long long r1 = min(w.cnt, r0 + rows_per_block);
  const int f0 = blockIdx.y * Fg;
  const int fg = min(Fg, F - f0);
  const int nh = fg * B * 2;
  // the flat walk over a tile's [tr, fg] elements advances blockDim.x
  // elements a step: step_r rows and step_f features
  const int step_r = blockDim.x / fg;
  const int step_f = blockDim.x - step_r * fg;
  const int r_first = threadIdx.x / fg;
  const int f_first = threadIdx.x - r_first * fg;

  for (int i = threadIdx.x; i < nh; i += blockDim.x) hist[i] = 0;

  const BinT* wbins = bins + w.start * F;
  const int8_t* wpay = pay + w.start * 2;
  for (long long t0 = r0; t0 < r1; t0 += tile_rows) {
    const int tr = (int)min((long long)tile_rows, r1 - t0);
    __syncthreads();  // the table is zeroed / the previous tile is consumed
    stage_tile(wbins, wpay, t0, tr, F, f0, fg, tbins, tpay);
    __syncthreads();
    int r = r_first;
    int fl = f_first;
    while (r < tr) {
      const int b = (int)tbins[r * fg + fl];
      if (b < B) {
        const int g = tpay[2 * r];
        const int h = tpay[2 * r + 1];
        int* hb = hist + ((size_t)fl * B + b) * 2;
        if (g != 0) atomicAdd(hb, g);
        if (h != 0) atomicAdd(hb + 1, h);
      }
      r += step_r;
      fl += step_f;
      if (fl >= fg) {
        fl -= fg;
        ++r;
      }
    }
  }
  __syncthreads();
  int* out = partials + ((size_t)blockIdx.x * F + f0) * B * 2;
  for (int i = threadIdx.x; i < nh; i += blockDim.x) out[i] = hist[i];
}

template <typename AccT>
__global__ void hist_reduce_kernel(const AccT* __restrict__ partials,
                                   int start, int cnt,
                                   const int* __restrict__ n_left, int side,
                                   int rows_per_block, int nblocks, int total,
                                   AccT* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const Window w = resolve_window(start, cnt, n_left, side);
  long long used = w.cnt <= 0 ? 0
                              : (w.cnt + rows_per_block - 1) / rows_per_block;
  if (used > nblocks) used = nblocks;
  AccT s = 0;
  for (long long b = 0; b < used; ++b) s += partials[(size_t)b * total + i];
  out[i] = s;
}

template <typename BinT, typename PayT, typename AccT>
cudaError_t launch(const void* bins, const void* pay, int start, int cnt,
                   const int* n_left, int side, int F, int B, int Fg,
                   int tile_rows, int nblocks, int rows_per_block,
                   int threads, void* partials, void* out,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<BinT, PayT, AccT>(Fg, B, tile_rows);
  const dim3 grid(nblocks, (F + Fg - 1) / Fg);
  const BinT* b = static_cast<const BinT*>(bins);
  AccT* part = static_cast<AccT*>(partials);
  cudaError_t e;
  if constexpr (sizeof(PayT) == 1) {
    e = cudaFuncSetAttribute(hist_partial_int_kernel<BinT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    hist_partial_int_kernel<BinT><<<grid, threads, smem, stream>>>(
        b, static_cast<const int8_t*>(pay), start, cnt, n_left, side, F, B,
        Fg, tile_rows, rows_per_block, part);
  } else {
    e = cudaFuncSetAttribute(hist_partial_kernel<BinT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    hist_partial_kernel<BinT><<<grid, threads, smem, stream>>>(
        b, static_cast<const float*>(pay), start, cnt, n_left, side, F, B,
        Fg, tile_rows, rows_per_block, part);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int total = F * B * 2;
  hist_reduce_kernel<AccT><<<(total + 255) / 256, 256, 0, stream>>>(
      part, start, cnt, n_left, side, rows_per_block, nblocks, total,
      static_cast<AccT*>(out));
  return cudaGetLastError();
}

template <typename PayT, typename AccT>
cudaError_t launch_bins(const void* bins, int bin_bytes, const void* pay,
                        int start, int cnt, const int* n_left, int side,
                        int F, int B, int Fg, int tile_rows, int nblocks,
                        int rows_per_block, int threads, void* partials,
                        void* out, cudaStream_t stream) {
  if (bin_bytes == 1)
    return launch<uint8_t, PayT, AccT>(bins, pay, start, cnt, n_left, side,
                                       F, B, Fg, tile_rows, nblocks,
                                       rows_per_block, threads, partials, out,
                                       stream);
  if (bin_bytes == 2)
    return launch<uint16_t, PayT, AccT>(bins, pay, start, cnt, n_left, side,
                                        F, B, Fg, tile_rows, nblocks,
                                        rows_per_block, threads, partials,
                                        out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Histogram of one window: partial pass + reduce pass, both on `stream`.
// int_path 0: f32 [n, 2] payload, f32 partials and output; 1: int8 [n, 2]
// payload, int32 partials and output. Returns the first CUDA error
// (0 = success).
extern "C" int hist_build(const void* bins, int bin_bytes, const void* pay,
                          int int_path, int start, int cnt,
                          const void* n_left, int side, int F, int B, int Fg,
                          int tile_rows, int nblocks, int rows_per_block,
                          int threads, void* partials, void* out,
                          void* stream) {
  const int* nl = static_cast<const int*>(n_left);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((side != 0 && nl == nullptr) || nblocks < 1 || Fg < 1 ||
      threads < 32 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (int_path == 0)
    return (int)launch_bins<float, float>(bins, bin_bytes, pay, start, cnt,
                                          nl, side, F, B, Fg, tile_rows,
                                          nblocks, rows_per_block, threads,
                                          partials, out, s);
  if (int_path == 1)
    return (int)launch_bins<int8_t, int>(bins, bin_bytes, pay, start, cnt,
                                         nl, side, F, B, Fg, tile_rows,
                                         nblocks, rows_per_block, threads,
                                         partials, out, s);
  return (int)cudaErrorInvalidValue;
}
