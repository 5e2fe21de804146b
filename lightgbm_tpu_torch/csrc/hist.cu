// K1: gradient/hessian histogram of a row window, for Hopper (sm_90a).
//
// Replaces: lightgbm_tpu/ops/pallas_hist.py, _hist_tiles / _hist_kernel
// (the Pallas TPU kernel behind hist_from_rows_pallas), float path:
//   out[f, b, c] = sum_s payload[s, c] * [rows[s, f] == b]
// over a contiguous window of a row-major [n, F] u8/u16 bin matrix and its
// [n, 2] f32 (grad, hess) payload.
//
// What bounds it on the H100: bytes. Each row is read once (F bin bytes +
// 8 payload bytes); the arithmetic is one add per (row, feature, channel).
// The TPU design (a one-hot times payload contraction on the MXU) has no
// reason to exist here: on Hopper this is a scatter into a small table.
//
// Design:
// - hist_partial_kernel: each block takes a contiguous range of the window
//   and keeps a private [Fg, B, 2] f32 histogram in dynamic shared memory
//   (28 features x 255 bins x 2 x 4 B = 57 KB at the Higgs shape). Rows are
//   staged tile by tile into shared memory with coalesced loads. Each warp
//   owns a fixed set of features of the block's histogram, so no two warps
//   ever write the same shared address.
// - Within a warp the 32 lanes take 32 consecutive rows of one feature.
//   Lanes that hit the same bin are grouped with __match_any_sync and
//   ranked within their group; the warp adds to the shared table in
//   rounds, round k taking the rank-k lanes, so no two lanes of a round
//   touch one address and each bin takes its rows in ascending lane
//   order. There are no atomics at all, so every sum is taken in one
//   fixed order: the result is bit-identical from run to run (float
//   atomics, in shared or in global memory, would let the order change
//   and flip near-tied splits).
// - Each block writes its partial histogram to a [nblocks, F, B, 2]
//   scratch, and hist_reduce_kernel sums the partials in block order.
//
// The window is [start, start + cnt) for side 0; for side 1 and 2 it is the
// left or right child of a partitioned window whose left count n_left lies
// in device memory (written by K2), so the grower needs no host read-back
// between the partition and the child histogram.
//
// Design limits (what a later PR redesigns): a hot bin serialises the
// warp into as many rounds as lanes share it (up to 32, the analog of
// shared-atomic contention on one address); a warp owns whole features, so at
// F = 28 over 8 warps the load is uneven (4 vs 3 features); every block
// writes a full partial table and the reduce pass re-reads them; and no
// TMA/cp.async double buffering of the row tiles.

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
    const float* psrc = wpay + t0 * 2;
    for (int i = threadIdx.x; i < tr * 2; i += blockDim.x) tpay[i] = psrc[i];
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

__global__ void hist_reduce_kernel(const float* __restrict__ partials,
                                   int start, int cnt,
                                   const int* __restrict__ n_left, int side,
                                   int rows_per_block, int nblocks, int total,
                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const Window w = resolve_window(start, cnt, n_left, side);
  long long used = w.cnt <= 0 ? 0
                              : (w.cnt + rows_per_block - 1) / rows_per_block;
  if (used > nblocks) used = nblocks;
  float s = 0.f;
  for (long long b = 0; b < used; ++b) s += partials[(size_t)b * total + i];
  out[i] = s;
}

template <typename BinT>
cudaError_t launch(const void* bins, const float* pay, int start, int cnt,
                   const int* n_left, int side, int F, int B, int Fg,
                   int tile_rows, int nblocks, int rows_per_block,
                   int threads, float* partials, float* out,
                   cudaStream_t stream) {
  const size_t smem = (size_t)Fg * B * 2 * sizeof(float) +
                      (size_t)tile_rows * 2 * sizeof(float) +
                      (size_t)tile_rows * Fg * sizeof(BinT);
  cudaError_t e = cudaFuncSetAttribute(
      hist_partial_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(nblocks, (F + Fg - 1) / Fg);
  hist_partial_kernel<BinT><<<grid, threads, smem, stream>>>(
      static_cast<const BinT*>(bins), pay, start, cnt, n_left, side, F, B, Fg,
      tile_rows, rows_per_block, partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int total = F * B * 2;
  hist_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      partials, start, cnt, n_left, side, rows_per_block, nblocks, total, out);
  return cudaGetLastError();
}

}  // namespace

// Histogram of one window: partial pass + fixed-order reduce pass, both on
// `stream`. Returns the first CUDA error (0 = success).
extern "C" int hist_build(const void* bins, int bin_bytes, const void* pay,
                          int start, int cnt, const void* n_left, int side,
                          int F, int B, int Fg, int tile_rows, int nblocks,
                          int rows_per_block, int threads, void* partials,
                          void* out, void* stream) {
  const float* p = static_cast<const float*>(pay);
  const int* nl = static_cast<const int*>(n_left);
  float* part = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((side != 0 && nl == nullptr) || nblocks < 1 || Fg < 1)
    return (int)cudaErrorInvalidValue;
  if (bin_bytes == 1)
    return (int)launch<uint8_t>(bins, p, start, cnt, nl, side, F, B, Fg,
                                tile_rows, nblocks, rows_per_block, threads,
                                part, o, s);
  if (bin_bytes == 2)
    return (int)launch<uint16_t>(bins, p, start, cnt, nl, side, F, B, Fg,
                                 tile_rows, nblocks, rows_per_block, threads,
                                 part, o, s);
  return (int)cudaErrorInvalidValue;
}
