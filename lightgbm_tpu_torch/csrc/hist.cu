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
// (row, feature, channel), which on this card is a shared-memory atomic.
// The TPU design (a one-hot times payload contraction on the MXU, with f32
// super-blocks of at most 131072 rows on the int path so that f32 sums
// stay exact) has no reason to exist here: on Hopper this is a scatter
// into a small table.
//
// Both paths sum integers, so every sum is exact and the same in any
// order, and one kernel (hist_kernel) serves both:
// - int path: the int8 payload is summed in int32;
// - float path: fixed point. Each channel c of the window gets a scale
//   2^k[c], the largest with cnt * max|pay[:, c]| * 2^k[c] <= 2^62
//   (max|pay| is a device tensor: the grower takes one amax over the
//   tree's payload at the root). Each row's value is rounded once to
//   round(pay * 2^k), an int64, the sums are exact int64, and the
//   result is converted once: sum * 2^-k to the nearest f32. The only
//   rounding is per row, below 2^-63 * cnt * max|pay| per entry in all,
//   so the result is at least as accurate as an f32 sum and bit-identical
//   from run to run. A non-finite max|pay| makes that channel NaN, so a
//   non-finite gradient still reaches the booster's non-finite guard.
//
// Design, against the four limits of the earlier design (a float path
// that ranked lanes in __match_any_sync rounds, per-block partials and a
// serial reduce launch, synchronous tile staging, one plan for every
// window size):
// 1. No rank rounds: integer sums need no fixed order. A block's threads
//    take a tile's (row, feature) elements flat, consecutive threads on
//    consecutive features, so one warp's adds spread over ~32 features'
//    tables and a bin that holds most rows (the hot-bin window) does not
//    make the lanes of a warp collide. The float path converts each row's
//    payload to fixed point once per tile, not once per feature. Lanes
//    are not combined with __match_any_sync / __reduce_add_sync: with
//    this walk they rarely share an entry, and the combining version was
//    slower on every window of the ladder, the hot-bin one included.
// 2. No partials and no reduce pass: a block keeps a private table in
//    dynamic shared memory and adds its non-zero entries into the window's
//    sums with global atomics, exact in any order (int path: the int32
//    result, zeroed by cudaMemsetAsync on the same stream; float path: a
//    zeroed int64 scratch, which hist_convert_kernel, one thread per sum,
//    converts to the f32 result). A histogram is a memset and one kernel
//    on the int path, a memset and two on the float path: converting in
//    the last block to finish (a completion ticket) measured slower, the
//    ticket's fence waiting on every block's atomics and one block
//    converting alone.
// 3. Asynchronous staging: row tiles arrive by TMA bulk copies
//    (cp.async.bulk completing on an mbarrier) into a ring of `stages`
//    tile buffers; one elected thread keeps the next tiles in flight while
//    all threads histogram the current one. A window starts at any row, so
//    a tile's bytes are not 16-byte aligned: the copy moves the aligned
//    middle of each stream (bins, payload) and lanes of warp 0 copy the
//    <= 15 ragged bytes at each end; the tile then sits in its buffer at
//    the source's offset mod 16.
// 4. A launch plan by window size (ops/histogram.py launch_plan, chosen
//    by timing plans on the window ladder): tiles of 1024 rows, halved
//    down to 128 for small windows so that they still spread over many
//    blocks; one block per tile up to as many as the card holds at once.
//
// Shared tables: int path, (g, h) int32 pairs (faster than g and h planes
// although a warp's pairs fall into 16 banks); float path, four planes of
// [Fg * B] 32-bit words (g low, g high, h low, h high), so a warp's words
// spread over all 32 banks. A 64-bit shared atomic add compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN.64) on sm_90a, so each int64 sum
// is two 32-bit words: the low word takes an atomic add whose return value
// gives the carry, the high word the value's high half plus that carry
// (add_fixed). That makes the float path's per-element cost four shared
// atomics to the int path's two; both are bounded by the shared-atomic
// rate, not by the bytes they read (PERF.md).
//
// The window is [start, start + cnt) for side 0; for side 1 and 2 it is the
// left or right child of a partitioned window whose left count n_left lies
// in device memory (written by K2), so the grower needs no host read-back
// between the partition and the child histogram. The block's share of the
// window's tiles is computed on the device from the resolved count.
//
// Feature groups: when the table does not fit beside the tile ring (wide
// u16 bins), blockIdx.y takes Fg features; its blocks still stage whole
// rows (a row's bins are contiguous), so such a window's bins are read
// once per feature group.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kMaxStages = 4;
// elements each thread loads ahead of their adds, per path (measured)
constexpr int kUnrollInt = 2;
constexpr int kUnrollFloat = 1;

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

__host__ __device__ __forceinline__ int round_up(int x, int a) {
  return (x + a - 1) / a * a;
}

// Dynamic shared memory of one block, in this order: the table (Fg * B
// entries of 8 bytes on the int path, 16 on the float path), the ring of
// `stages` (bins, payload) tile buffers (16 bytes of slack each for the
// source's offset mod 16), the float path's fixed-point payload of the
// current tile ([tile, 4] u32), then the stage mbarriers.
// ops/histogram.py smem_bytes() mirrors it.
struct Layout {
  int table, bins_slot, pay_slot, ring, cpay, total;
};

__host__ __device__ __forceinline__ Layout layout(int F, int Fg, int B,
                                                  int bin_bytes, int int_path,
                                                  int tile_rows, int stages) {
  Layout l;
  l.table = round_up(Fg * B * 2 * (int_path ? 4 : 8), 128);
  l.bins_slot = round_up(tile_rows * F * bin_bytes + 16, 128);
  l.pay_slot = round_up(tile_rows * (int_path ? 2 : 8) + 16, 128);
  l.ring = stages * (l.bins_slot + l.pay_slot);
  l.cpay = int_path ? 0 : round_up(tile_rows * 16, 128);
  l.total = l.table + l.ring + l.cpay + 128;
  return l;
}

// ---- 64-bit fixed-point adds into the shared table ----
//
// A 64-bit sum is two 32-bit words in two planes of the table. Every carry
// out of the low word reaches the high word, so the pair holds the exact
// sum mod 2^64 in any order.
__device__ __forceinline__ void add_fixed(uint32_t lo_a, uint32_t hi_a,
                                          uint32_t lo, uint32_t hi) {
  uint32_t carry = 0;
  if (lo) {
    uint32_t old;
    asm volatile("atom.shared.add.u32 %0, [%1], %2;\n"
                 : "=r"(old)
                 : "r"(lo_a), "r"(lo));
    carry = (old + lo) < old ? 1u : 0u;
  }
  hi += carry;
  if (hi) asm volatile("red.shared.add.u32 [%0], %1;\n" ::"r"(hi_a),
                       "r"(hi));
}

__device__ __forceinline__ void add_s32(uint32_t a, int v) {
  if (v) asm volatile("red.shared.add.s32 [%0], %1;\n" ::"r"(a), "r"(v));
}

// The largest k with cnt * amax * 2^k <= 2^62 (amax < 2^e by frexpf), so
// that every row's |round(x * 2^k)| and every sum of the window fit int64.
__device__ __forceinline__ int fixed_exponent(float amax, long long cnt) {
  int e = 0;
  frexpf(amax, &e);
  const int lc = cnt > 1 ? 64 - __clzll(cnt - 1) : 0;  // cnt <= 2^lc
  return 62 - lc - e;
}

// The float path's per-channel scales of a window, and its conversion of
// an int64 sum to f32: sum * 2^-k, by a multiply with the exact power of
// two where 2^-k is a normal float (the same bits as ldexpf), else ldexpf;
// NaN for a channel whose max |payload| is not finite.
struct Scale {
  int k[2];
  bool fin[2];
  __device__ explicit Scale(const float* absmax, long long cnt) {
    for (int c = 0; c < 2; ++c) {
      const float a = absmax[c];
      fin[c] = isfinite(a);
      k[c] = fin[c] ? fixed_exponent(a, cnt) : 0;
    }
  }
  __device__ float to_f32(long long v, int c) const {
    const float f = __ll2float_rn(v);
    if (!fin[c]) return __int_as_float(0x7fc00000);
    if (k[c] >= -127 && k[c] <= 126)
      return f * __int_as_float((127 - k[c]) << 23);
    return ldexpf(f, -k[c]);
  }
};

// The float path's conversion as its own launch: one thread per sum.
__global__ void hist_convert_kernel(const unsigned long long* __restrict__ acc,
                                    int start, int cnt,
                                    const int* __restrict__ n_left, int side,
                                    int n, const float* __restrict__ absmax,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Window w = resolve_window(start, cnt, n_left, side);
  const Scale sc(absmax, w.cnt);
  out[i] = sc.to_f32((long long)acc[i], i & 1);
}

template <typename BinT, bool kInt>
__global__ void __launch_bounds__(1024)
    hist_kernel(const BinT* __restrict__ bins, const void* __restrict__ pay,
                int start, int cnt, const int* __restrict__ n_left, int side,
                int F, int B, int Fg, int tile_rows, int stages,
                const float* __restrict__ absmax,
                unsigned long long* __restrict__ acc, void* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(F, Fg, B, (int)sizeof(BinT), kInt, tile_rows,
                          stages);
  unsigned char* ring = smem + L.table;
  uint4* cpay = reinterpret_cast<uint4*>(ring + L.ring);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + L.ring + L.cpay);

  constexpr int prow = kInt ? 2 : 8;  // payload bytes per row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Window w = resolve_window(start, cnt, n_left, side);
  const int f0 = blockIdx.y * Fg;
  const int fg = min(Fg, F - f0);
  const long long ntiles = w.cnt > 0 ? (w.cnt + tile_rows - 1) / tile_rows : 0;
  const long long per_block = (ntiles + gridDim.x - 1) / gridDim.x;
  const long long t_begin = (long long)blockIdx.x * per_block;
  const long long t_end = min(ntiles, t_begin + per_block);

  // float path: the per-channel scales of this window
  double s0 = 1.0, s1 = 1.0;
  bool fin0 = true, fin1 = true;
  if constexpr (!kInt) {
    const Scale sc(absmax, w.cnt);
    fin0 = sc.fin[0];
    fin1 = sc.fin[1];
    s0 = ldexp(1.0, sc.k[0]);
    s1 = ldexp(1.0, sc.k[1]);
  }

  if (t_begin < t_end) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    {
      uint4* t4 = reinterpret_cast<uint4*>(smem);
      const int n4 = L.table / 16;
      for (int i = tid; i < n4; i += blockDim.x) t4[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();  // barriers initialised

    const unsigned char* bbase = reinterpret_cast<const unsigned char*>(bins);
    const unsigned char* pbase = reinterpret_cast<const unsigned char*>(pay);
    const long long brow = (long long)F * sizeof(BinT);
    auto stage = [&](long long t, int s) {
      const long long row0 = w.start + t * tile_rows;
      const int tr = (int)min((long long)tile_rows, w.cnt - t * tile_rows);
      const unsigned char* gb = bbase + row0 * brow;
      const unsigned char* gp = pbase + row0 * prow;
      const uint32_t nb = (uint32_t)(tr * brow);
      const uint32_t np = (uint32_t)(tr * prow);
      unsigned char* slot = ring + s * (L.bins_slot + L.pay_slot);
      if (lane == 0) mbar_arrive_tx(&bars[s], body_bytes(gb, nb) +
                                                  body_bytes(gp, np));
      stage_stream(gb, nb, slot, &bars[s], lane);
      stage_stream(gp, np, slot + L.bins_slot, &bars[s], lane);
    };
    if (warp == 0)
      for (int s = 0; s < stages && t_begin + s < t_end; ++s)
        stage(t_begin + s, s);
    __syncthreads();  // the prologue's ragged bytes are visible

    // the flat walk over a tile's [tr, fg] elements advances blockDim.x
    // elements a step: step_r rows and step_f features
    const int step_r = blockDim.x / fg;
    const int step_f = blockDim.x - step_r * fg;
    const int r_first = tid / fg;
    const int f_first = tid - r_first * fg;
    const uint32_t table_a = saddr(smem);
    const uint32_t plane = (uint32_t)(fg * B) * 4u;  // bytes
    constexpr uint32_t kStride = kInt ? 8u : 4u;  // bytes per entry
    constexpr int U = kInt ? kUnrollInt : kUnrollFloat;

    for (long long t = t_begin; t < t_end; ++t) {
      const int s = (int)((t - t_begin) % stages);
      const uint32_t parity = (uint32_t)(((t - t_begin) / stages) & 1);
      const long long row0 = w.start + t * tile_rows;
      const int tr = (int)min((long long)tile_rows, w.cnt - t * tile_rows);
      unsigned char* slot = ring + s * (L.bins_slot + L.pay_slot);
      const BinT* tb = reinterpret_cast<const BinT*>(
          slot + (reinterpret_cast<uintptr_t>(bbase + row0 * brow) & 15));
      const unsigned char* tp =
          slot + L.bins_slot +
          (reinterpret_cast<uintptr_t>(pbase + row0 * prow) & 15);
      mbar_wait(&bars[s], parity);

      if constexpr (!kInt) {
        // the tile's payload rows in fixed point, once per row
        const float* fp = reinterpret_cast<const float*>(tp);
        for (int r = tid; r < tr; r += blockDim.x) {
          const long long v0 = fin0 ? __double2ll_rn((double)fp[2 * r] * s0)
                                    : 0;
          const long long v1 =
              fin1 ? __double2ll_rn((double)fp[2 * r + 1] * s1) : 0;
          cpay[r] = make_uint4((uint32_t)v0, (uint32_t)(v0 >> 32),
                               (uint32_t)v1, (uint32_t)(v1 >> 32));
        }
        __syncthreads();
      }

      // each step loads U elements' bins and payloads before it adds
      // any of them
      int r = r_first;
      int fl = f_first;
      for (int e0 = 0; e0 < tr * fg; e0 += U * blockDim.x) {
        uint32_t ea[U];
        uint4 pv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int b = r < tr ? (int)tb[(size_t)r * F + f0 + fl] : B;
          // ~0: nothing to add (past the tile, or a bin out of range)
          ea[u] = b < B ? table_a + (uint32_t)(fl * B + b) * kStride : ~0u;
          if constexpr (kInt) {
            const int8_t* ip = reinterpret_cast<const int8_t*>(tp);
            pv[u] = b < B ? make_uint4((uint32_t)(int)ip[2 * r],
                                       (uint32_t)(int)ip[2 * r + 1], 0, 0)
                          : make_uint4(0, 0, 0, 0);
          } else {
            pv[u] = b < B ? cpay[r] : make_uint4(0, 0, 0, 0);
          }
          r += step_r;
          fl += step_f;
          if (fl >= fg) {
            fl -= fg;
            ++r;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (ea[u] == ~0u) continue;
          if constexpr (kInt) {
            add_s32(ea[u], (int)pv[u].x);
            add_s32(ea[u] + 4u, (int)pv[u].y);
          } else {
            add_fixed(ea[u], ea[u] + plane, pv[u].x, pv[u].y);
            add_fixed(ea[u] + 2 * plane, ea[u] + 3 * plane, pv[u].z,
                      pv[u].w);
          }
        }
      }
      __syncthreads();  // buffer s (and the fixed-point rows) consumed
      if (warp == 0 && t + stages < t_end) stage(t + stages, s);
    }

    const int P = fg * B;
    // the block's non-zero entries into the window's sums ([F, B, 2])
    if constexpr (kInt) {
      const int* table = reinterpret_cast<const int*>(smem);
      int* o = static_cast<int*>(out) + (size_t)f0 * B * 2;
      for (int i = tid; i < 2 * P; i += blockDim.x) {
        const int v = table[i];
        if (v) atomicAdd(o + i, v);
      }
    } else {
      const uint32_t* table = reinterpret_cast<const uint32_t*>(smem);
      for (int i = tid; i < 2 * P; i += blockDim.x) {
        const int c = i >= P;
        const int key = i - c * P;
        const unsigned long long v =
            ((unsigned long long)table[(2 * c + 1) * P + key] << 32) |
            table[2 * c * P + key];
        if (v) atomicAdd(acc + ((size_t)f0 * B + key) * 2 + c, v);
      }
    }
  }
}

template <typename BinT, bool kInt>
cudaError_t launch(const void* bins, const void* pay, int start, int cnt,
                   const int* n_left, int side, int F, int B, int Fg,
                   int tile_rows, int stages, int nblocks, int threads,
                   const float* absmax, void* scratch, void* out,
                   cudaStream_t stream) {
  const Layout L = layout(F, Fg, B, (int)sizeof(BinT), kInt, tile_rows,
                          stages);
  auto* kern = hist_kernel<BinT, kInt>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return e;
  unsigned long long* acc = static_cast<unsigned long long*>(scratch);
  // the sums' target: int path, the result; float path, the int64 scratch
  const int n = F * B * 2;
  e = kInt ? cudaMemsetAsync(out, 0, (size_t)n * sizeof(int), stream)
           : cudaMemsetAsync(acc, 0, (size_t)n * sizeof(*acc), stream);
  if (e != cudaSuccess) return e;
  const dim3 grid(nblocks, (F + Fg - 1) / Fg);
  kern<<<grid, threads, L.total, stream>>>(
      static_cast<const BinT*>(bins), pay, start, cnt, n_left, side, F, B, Fg,
      tile_rows, stages, absmax, acc, out);
  e = cudaGetLastError();
  if (e != cudaSuccess || kInt) return e;
  hist_convert_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      acc, start, cnt, n_left, side, n, absmax, static_cast<float*>(out));
  return cudaGetLastError();
}

template <bool kInt>
cudaError_t launch_bins(const void* bins, int bin_bytes, const void* pay,
                        int start, int cnt, const int* n_left, int side,
                        int F, int B, int Fg, int tile_rows, int stages,
                        int nblocks, int threads, const float* absmax,
                        void* scratch, void* out, cudaStream_t stream) {
  if (bin_bytes == 1)
    return launch<uint8_t, kInt>(bins, pay, start, cnt, n_left, side, F, B,
                                 Fg, tile_rows, stages, nblocks, threads,
                                 absmax, scratch, out, stream);
  if (bin_bytes == 2)
    return launch<uint16_t, kInt>(bins, pay, start, cnt, n_left, side, F, B,
                                  Fg, tile_rows, stages, nblocks, threads,
                                  absmax, scratch, out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of one block (the layout above), for the wrapper's
// launch plan to check against its own count.
extern "C" int hist_smem_bytes(int F, int Fg, int B, int bin_bytes,
                               int int_path, int tile_rows, int stages) {
  return layout(F, Fg, B, bin_bytes, int_path, tile_rows, stages).total;
}

// Histogram of one window, all on `stream`: int_path 1, int8 [n, 2]
// payload and int32 output, no scratch (a memset and one kernel); 0, f32
// [n, 2] payload and f32 output, with `absmax` the device address of the
// two channels' max |payload| (an upper bound for the window) and
// `scratch` F * B * 2 int64 words (a memset and two kernels). Returns the
// first CUDA error (0 = success).
extern "C" int hist_build(const void* bins, int bin_bytes, const void* pay,
                          int int_path, int start, int cnt,
                          const void* n_left, int side, int F, int B, int Fg,
                          int tile_rows, int stages, int nblocks, int threads,
                          const void* absmax, void* scratch, void* out,
                          void* stream) {
  const int* nl = static_cast<const int*>(n_left);
  const float* am = static_cast<const float*>(absmax);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((side != 0 && nl == nullptr) || nblocks < 1 || Fg < 1 || Fg > F ||
      threads < 32 || threads > 1024 || threads % 32 != 0 || stages < 2 ||
      stages > kMaxStages || tile_rows < 1 ||
      (int_path == 0 && (am == nullptr || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (int_path == 0)
    return (int)launch_bins<false>(bins, bin_bytes, pay, start, cnt, nl,
                                   side, F, B, Fg, tile_rows, stages,
                                   nblocks, threads, am, scratch, out, s);
  if (int_path == 1)
    return (int)launch_bins<true>(bins, bin_bytes, pay, start, cnt, nl,
                                  side, F, B, Fg, tile_rows, stages, nblocks,
                                  threads, am, scratch, out, s);
  return (int)cudaErrorInvalidValue;
}
