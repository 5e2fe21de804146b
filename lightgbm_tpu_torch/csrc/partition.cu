// K2: stable two-way partition of a row window, for Hopper (sm_90a).
//
// Replaces: lightgbm_tpu/ops/partition_kernel.py, route_pair /
// _route_pair_kernel (the Pallas TPU butterfly router), and takes the place
// of the variadic sort in the JAX compact grower's part_apply. Rows of a
// leaf's contiguous window whose split decision is "left" move to the front
// of the same window in the other buffer of a ping-pong pair, the others to
// the back, each side in its original order:
//   left  row -> dst[lefts before it]
//   right row -> dst[n_left + rights before it]
// A row is its F bins (u8/u16), optionally its payload and its int32 row
// id. The payload is the row's (grad, hess) pair: 8 bytes (an f32 pair) on
// the float path, 2 bytes (an int8 pair, moved as one 16-bit word) on the
// quantized path. The decision is the range rule of the JAX grower's
// chunk_goleft (ops/grow.py), for plain and EFB-bundled bin columns: a
// row whose bin v in column `col` is the missing position follows
// default_left; any other row goes right iff lo <= v <= hi. A plain split
// at threshold t is lo = t + 1, hi = INT_MAX, the missing position its NaN
// bin (or -1); a bundle member at offset off with nb bins is lo = off + t,
// hi = off + nb - 2, the missing position off + nb - 2 when it has a NaN
// bin (ops/partition.py RangeRules makes both). A categorical split takes
// the membership rule instead: a row goes left iff bit v of the split's
// bitset (one bit per value the column holds, in bundle-position space, the
// EFB layout folded in by RangeRules.bitsets) is set. The kernels are
// templated on the rule, so the range rule's code is the same as without
// the membership rule. The result is a permutation, so it is bit-exact
// against the plain version.
//
// What bounds it on the H100: bytes. The least a call can move is the
// window read once and written once, 2 * cnt * (F * bin bytes + payload
// bytes + 4). A right row's destination depends on the window's n_left,
// which is known only when every row has been decided, so a kernel that
// reads the window once must hold all of it until then. Two paths, chosen
// per window by the wrapper's plan (ops/partition.py partition_plan):
//
// 1. Resident, one launch (part_resident), for windows that fit in the
//    shared memory of one block per SM (about 730k rows of 28 u8 bins, an
//    f32 pair and an id). A cooperative launch; block b stages its
//    contiguous slice of the window (bins, payload, ids) into dynamic
//    shared memory once, by TMA bulk copies (tma.cuh), ranks its rows
//    stably, writes its left count and passes one grid barrier
//    (cooperative_groups grid.sync). Each block then sums the counts of the
//    blocks before it (its left offset) and of all blocks (n_left) and
//    writes its left run and its right run as two contiguous spans.
//    Bytes: the bound's; scratch: one int per block, never cleared.
// 2. Streaming, two launches, for larger windows (the root and the first
//    levels of a tree):
//    - part_column reads only column f, one tile of `rows` rows per block,
//      counts the tile's lefts and finds the lefts before it by a
//      decoupled look-back over the tiles before (tiles in block order, as
//      CUB's single-pass scan takes them): each tile publishes its count,
//      then its inclusive prefix, in one 64-bit status word per tile. The
//      last tile writes n_left.
//    - part_move streams the tiles through a ring of `stages` shared-memory
//      buffers filled by TMA, in as many blocks as the card holds at once,
//      each taking a contiguous run of tiles; it ranks each tile's rows
//      stably and writes its two spans at the offsets from its status word,
//      which it then clears: the status words are zero at the start of
//      every call (the wrapper zeroes them once, when it allocates them).
//    Bytes: the window read once and written once, plus column f, which
//    at a row of fewer than 32 bytes costs about the bins read a second
//    time (every 32-byte sector holds some row's byte f).
//
// Within a block or tile, each thread ranks a run of consecutive rows: it
// counts its lefts, a block scan gives its offset, and it writes each row's
// slot in a u16 rank table (lefts first, then rights, both in row order).
// The spans are written with consecutive threads on consecutive units of
// 16, 8, 4, 2 or 1 bytes (the largest that divides the row and both
// windows' addresses), each unit read from the staged row the rank table
// names, so stores coalesce whatever the row width (13-byte rows
// included). Staging waits on device memory once per tile: warp 0 loads
// the ragged bytes of all three streams before it stores any.
//
// Design limits: a block or tile holds at most 65535 rows (u16 ranks); a
// row must fit twice in one block's shared memory beside the rank table
// (the plan raises otherwise: F up to ~58k u16 bins); cnt < 2^31. Each
// resident launch pays a fixed ~4-5 us of dependent round trips (TMA
// load, grid barrier, counts, stores), the most of a small window's
// time, and the column pass re-reads about the bins (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRows = 65535;        // rows per slice or tile (u16 ranks)
constexpr int kMaxStages = 16;         // the barrier area holds 16
constexpr int kColumnThreads = 512;
constexpr unsigned long long kAggregate = 1ull << 32;  // status flags
constexpr unsigned long long kPrefix = 2ull << 32;

__host__ __device__ __forceinline__ long long up128(long long x) {
  return (x + 127) / 128 * 128;
}

// Dynamic shared memory of one block, in this order: `stages` stage
// buffers, each a bins slot, a payload slot (none without a payload) and
// an ids slot (always budgeted) with 16 bytes of slack each for the
// source's offset mod 16; the u16 rank table; the scan's 64 ints; the
// stage mbarriers. ops/partition.py smem_bytes() mirrors it.
struct Layout {
  long long bins_slot, pay_slot, ids_slot, stage, perm, total;
};

__host__ __device__ __forceinline__ Layout layout(int rows, int F,
                                                  int bin_bytes,
                                                  int pay_bytes, int stages) {
  Layout l;
  l.bins_slot = up128((long long)rows * F * bin_bytes + 16);
  l.pay_slot = pay_bytes ? up128((long long)rows * pay_bytes + 16) : 0;
  l.ids_slot = up128((long long)rows * 4 + 16);
  l.stage = l.bins_slot + l.pay_slot + l.ids_slot;
  l.perm = up128((long long)rows * 2);
  l.total = stages * l.stage + l.perm + 256 + 128;
  return l;
}

// The three streams of a row: bins, payload, ids. Pointers are the
// window's first row (src null: the stream is absent); unit: the bytes of
// one store when a row is moved.
struct Streams {
  const unsigned char* src[3];
  unsigned char* dst[3];
  int row_bytes[3];
  int unit[3];
};

// The split decision on one bin: see the top of the file. v is a u8/u16
// bin (0 to 65535), so hi = INT_MAX never overflows and a missing position
// of -1 never matches. kSet: the membership rule, bit v & 7 of byte v >> 3
// of `bits` (nbits bits; a value past them goes right), read through the
// read-only cache: a split's bitset is a few dozen bytes that every thread
// reads.
struct Rule {
  int lo, hi, nan_pos, dl;
  const unsigned char* bits;
  int nbits;
};

template <bool kSet>
__device__ __forceinline__ bool go_left(int v, const Rule& r) {
  if (kSet)
    return v < r.nbits && ((__ldg(r.bits + (v >> 3)) >> (v & 7)) & 1);
  return v == r.nan_pos ? (r.dl != 0) : !(v >= r.lo && v <= r.hi);
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// Where stream k of the rows [row0, ...) sits in a stage buffer.
__device__ __forceinline__ unsigned char* staged(const Streams& s,
                                                 const Layout& L,
                                                 unsigned char* stage, int k,
                                                 long long row0) {
  const long long slot =
      k == 0 ? 0 : (k == 1 ? L.bins_slot : L.bins_slot + L.pay_slot);
  const uintptr_t g =
      reinterpret_cast<uintptr_t>(s.src[k] + row0 * s.row_bytes[k]);
  return stage + slot + (g & 15);
}

// Warp 0 starts the copies of rows [row0, row0 + nr) of every stream into
// a stage buffer, all completing on `bar`, as tma.cuh's stage_stream does
// for one stream: lane 0 bulk-copies each stream's 16-byte-aligned middle,
// and lanes 0-14 and 16-30 copy the ragged head and tail bytes. Every
// lane loads its ragged bytes of all three streams before it stores any,
// so the warp waits for one round trip to device memory, not three.
__device__ __forceinline__ void stage_rows(const Streams& s, const Layout& L,
                                           unsigned char* stage,
                                           long long row0, int nr,
                                           uint64_t* bar, int lane) {
  unsigned char v[3];
  unsigned char* at[3];
  uint32_t tx = 0;
  for (int k = 0; k < 3; ++k) {
    at[k] = nullptr;
    if (!s.src[k]) continue;
    const unsigned char* g = s.src[k] + row0 * s.row_bytes[k];
    const uint32_t n = (uint32_t)nr * s.row_bytes[k];
    const uintptr_t gs = reinterpret_cast<uintptr_t>(g);
    const uintptr_t a = (gs + 15) & ~uintptr_t(15);
    const uintptr_t z = (gs + n) & ~uintptr_t(15);
    int i = -1;
    if (z > a) {
      tx += (uint32_t)(z - a);
      const int head = (int)(a - gs);
      const int tail = (int)(gs + n - z);
      if (lane < head)
        i = lane;
      else if (lane >= 16 && lane - 16 < tail)
        i = (int)(z - gs) + lane - 16;
    } else if (lane < (int)n) {
      i = lane;
    }
    if (i >= 0) {
      v[k] = g[i];
      at[k] = staged(s, L, stage, k, row0) + i;
    }
  }
  if (lane == 0) {
    mbar_arrive_tx(bar, tx);
    for (int k = 0; k < 3; ++k) {
      if (!s.src[k]) continue;
      const unsigned char* g = s.src[k] + row0 * s.row_bytes[k];
      const uint32_t n = body_bytes(g, (uint32_t)nr * s.row_bytes[k]);
      if (n) {
        const uintptr_t gs = reinterpret_cast<uintptr_t>(g);
        const uintptr_t a = (gs + 15) & ~uintptr_t(15);
        bulk_copy(staged(s, L, stage, k, row0) + (a - gs),
                  reinterpret_cast<const void*>(a), n, bar);
      }
    }
  }
  for (int k = 0; k < 3; ++k)
    if (at[k]) *at[k] = v[k];
}

// Ranks the nr staged rows stably: perm[0, nl) takes the left rows' slice
// indices in row order, perm[nl, nr) the right rows'. Returns nl to every
// thread. `scan` holds 32 ints.
template <typename BinT, bool kSet>
__device__ int rank_rows(const BinT* bins, int F, int f, const Rule& rule,
                         int nr, uint16_t* perm, int* scan) {
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ch = (nr + T - 1) / T;
  const int r0 = min(nr, tid * ch);
  const int r1 = min(nr, r0 + ch);
  int c = 0;
  for (int r = r0; r < r1; ++r)
    c += go_left<kSet>((int)bins[(size_t)r * F + f], rule);
  int x = c;  // inclusive scan within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < T / 32 ? scan[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    scan[lane] = v;  // inclusive over warps
  }
  __syncthreads();
  const int nl = scan[T / 32 - 1];
  int lo = x - c + (warp > 0 ? scan[warp - 1] : 0);
  for (int r = r0; r < r1; ++r) {
    if (go_left<kSet>((int)bins[(size_t)r * F + f], rule))
      perm[lo++] = (uint16_t)r;
    else
      perm[nl + r - lo] = (uint16_t)r;
  }
  __syncthreads();  // perm complete; scan free again
  return nl;
}

template <int U>
struct Unit;
template <>
struct Unit<1> {
  using T = uint8_t;
};
template <>
struct Unit<2> {
  using T = uint16_t;
};
template <>
struct Unit<4> {
  using T = uint32_t;
};
template <>
struct Unit<8> {
  using T = uint2;
};
template <>
struct Unit<16> {
  using T = uint4;
};

// The block's rows of one stream to their destinations, consecutive
// threads on consecutive U-byte units: rank k < nl goes to window row
// left0 + k, rank k >= nl to right0 + k - nl.
template <int U>
__device__ __forceinline__ void move_units(unsigned char* dst,
                                           const unsigned char* src,
                                           int row_bytes,
                                           const uint16_t* perm, int nr,
                                           int nl, long long left0,
                                           long long right0) {
  using V = typename Unit<U>::T;
  const int ru = row_bytes / U;
  const int T = blockDim.x;
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  const int n = nr * ru;
  int k = threadIdx.x / ru;
  int j = threadIdx.x - k * ru;
  const int sk = T / ru;
  const int sj = T - sk * ru;
  for (int i = threadIdx.x; i < n; i += T) {
    const long long row = k < nl ? left0 + k : right0 + (k - nl);
    d[row * ru + j] = s[(int)perm[k] * ru + j];
    k += sk;
    j += sj;
    if (j >= ru) {
      j -= ru;
      ++k;
    }
  }
}

__device__ __forceinline__ void move_rows(const Streams& s, int k,
                                          const unsigned char* src,
                                          const uint16_t* perm, int nr,
                                          int nl, long long left0,
                                          long long right0) {
  unsigned char* d = s.dst[k];
  const int rb = s.row_bytes[k];
  switch (s.unit[k]) {
    case 16:
      move_units<16>(d, src, rb, perm, nr, nl, left0, right0);
      break;
    case 8:
      move_units<8>(d, src, rb, perm, nr, nl, left0, right0);
      break;
    case 4:
      move_units<4>(d, src, rb, perm, nr, nl, left0, right0);
      break;
    case 2:
      move_units<2>(d, src, rb, perm, nr, nl, left0, right0);
      break;
    default:
      move_units<1>(d, src, rb, perm, nr, nl, left0, right0);
  }
}

// Path 1: the whole window in the blocks' shared memory, one launch.
template <typename BinT, bool kSet>
__global__ void __launch_bounds__(512, 2)
    part_resident(Streams s, long long cnt, int F, int f, Rule rule,
                  int rows, int* __restrict__ counts,
                  int* __restrict__ n_left) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(rows, F, (int)sizeof(BinT), s.row_bytes[1], 1);
  uint16_t* perm = reinterpret_cast<uint16_t*>(smem + L.stage);
  int* scan = reinterpret_cast<int*>(smem + L.stage + L.perm);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.stage + L.perm + 256);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * rows;
  const int nr = (int)max(0LL, min((long long)rows, cnt - row0));

  int nl = 0;
  if (nr > 0) {
    if (tid == 0) {
      mbar_init(bar);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // barrier initialised
    if (warp == 0) stage_rows(s, L, smem, row0, nr, bar, lane);
    __syncthreads();  // the ragged bytes are visible
    mbar_wait(bar, 0);
    nl = rank_rows<BinT, kSet>(
        reinterpret_cast<const BinT*>(staged(s, L, smem, 0, row0)), F, f,
        rule, nr, perm, scan);
  }
  if (tid == 0) counts[blockIdx.x] = nl;
  cg::this_grid().sync();

  // lefts before this block, and the window's n_left
  if (warp == 0) {
    int before = 0, total = 0;
    for (int i = lane; i < (int)gridDim.x; i += 32) {
      const int v = __ldcg(counts + i);
      total += v;
      if (i < (int)blockIdx.x) before += v;
    }
    before = __reduce_add_sync(0xffffffffu, before);
    total = __reduce_add_sync(0xffffffffu, total);
    if (lane == 0) {
      scan[32] = before;
      scan[33] = total;
    }
  }
  __syncthreads();
  const long long before = scan[32];
  const long long total = scan[33];
  if (blockIdx.x == 0 && tid == 0) *n_left = (int)total;
  if (nr > 0)
    for (int k = 0; k < 3; ++k)
      if (s.src[k])
        move_rows(s, k, staged(s, L, smem, k, row0), perm, nr, nl, before,
                  total + (row0 - before));
}

// Path 2, pass 1: column f of one tile per block; lefts before each tile
// by decoupled look-back; n_left from the last tile.
template <typename BinT, bool kSet>
__global__ void __launch_bounds__(kColumnThreads)
    part_column(const BinT* __restrict__ bins, long long cnt, int F, int f,
                Rule rule, int rows,
                unsigned long long* __restrict__ status,
                int* __restrict__ n_left) {
  __shared__ int warp_sums[kColumnThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long tile = blockIdx.x;
  const long long row0 = tile * rows;
  const int tr = (int)min((long long)rows, cnt - row0);
  const BinT* col = bins + row0 * F + f;
  int c = 0;
  for (int r = tid; r < tr; r += kColumnThreads)
    c += go_left<kSet>((int)__ldg(col + (size_t)r * F), rule);
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (warp != 0) return;
  int agg = lane < kColumnThreads / 32 ? warp_sums[lane] : 0;
  agg = __reduce_add_sync(0xffffffffu, agg);
  int excl = 0;
  if (tile == 0) {
    if (lane == 0) st_relaxed(status, kPrefix | (unsigned)agg);
  } else {
    if (lane == 0) st_relaxed(status + tile, kAggregate | (unsigned)agg);
    // lane l reads tile pred - l: the window of the 32 tiles before
    for (long long pred = tile - 1;; pred -= 32) {
      const long long i = pred - lane;
      unsigned long long v = i >= 0 ? ld_relaxed(status + i) : kPrefix;
      while (__any_sync(0xffffffffu, (v >> 32) == 0))
        if ((v >> 32) == 0) v = ld_relaxed(status + i);
      const unsigned pm = __ballot_sync(0xffffffffu, (v >> 32) == 2);
      // up to the nearest tile that has its inclusive prefix
      const int last = pm ? __ffs(pm) - 1 : 31;
      excl += __reduce_add_sync(0xffffffffu,
                                lane <= last ? (int)(uint32_t)v : 0);
      if (pm) break;
    }
    if (lane == 0) st_relaxed(status + tile, kPrefix | (unsigned)(excl + agg));
  }
  if (lane == 0 && tile == (long long)gridDim.x - 1) *n_left = excl + agg;
}

// Path 2, pass 2: a block's contiguous run of tiles through a ring of
// `stages` buffers; each tile's spans at the offsets from its status word,
// which is cleared.
template <typename BinT, bool kSet>
__global__ void __launch_bounds__(512, 2)
    part_move(Streams s, long long cnt, int F, int f, Rule rule, int rows,
              int stages, long long ntiles,
              unsigned long long* __restrict__ status,
              const int* __restrict__ n_left_ptr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(rows, F, (int)sizeof(BinT), s.row_bytes[1], stages);
  uint16_t* perm = reinterpret_cast<uint16_t*>(smem + stages * L.stage);
  int* scan = reinterpret_cast<int*>(smem + stages * L.stage + L.perm);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + stages * L.stage + L.perm + 256);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long per = (ntiles + gridDim.x - 1) / gridDim.x;
  const long long t_begin = (long long)blockIdx.x * per;
  const long long t_end = min(ntiles, t_begin + per);
  if (t_begin >= t_end) return;
  const long long n_left = *n_left_ptr;

  if (tid == 0) {
    for (int k = 0; k < stages; ++k) mbar_init(&bars[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // barriers initialised
  auto stage = [&](long long tl, int k) {
    const long long row0 = tl * rows;
    const int tr = (int)min((long long)rows, cnt - row0);
    stage_rows(s, L, smem + k * L.stage, row0, tr, &bars[k], lane);
  };
  if (warp == 0)
    for (int k = 0; k < stages && t_begin + k < t_end; ++k)
      stage(t_begin + k, k);
  __syncthreads();  // the prologue's ragged bytes are visible

  // the tiles' inclusive prefixes of lefts, left by part_column; thread 0
  // loads the next tile's while the block works on this one
  unsigned long long next = tid == 0 ? status[t_begin] : 0ull;
  for (long long tl = t_begin; tl < t_end; ++tl) {
    const int k = (int)((tl - t_begin) % stages);
    const uint32_t parity = (uint32_t)(((tl - t_begin) / stages) & 1);
    const long long row0 = tl * rows;
    const int tr = (int)min((long long)rows, cnt - row0);
    unsigned char* buf = smem + k * L.stage;
    if (tid == 0) {
      scan[32] = (int)(uint32_t)next;
      status[tl] = 0ull;
      if (tl + 1 < t_end) next = status[tl + 1];
    }
    mbar_wait(&bars[k], parity);
    const int nl = rank_rows<BinT, kSet>(
        reinterpret_cast<const BinT*>(staged(s, L, buf, 0, row0)), F, f, rule,
        tr, perm, scan);
    const long long before = scan[32] - nl;
    for (int q = 0; q < 3; ++q)
      if (s.src[q])
        move_rows(s, q, staged(s, L, buf, q, row0), perm, tr, nl, before,
                  n_left + (row0 - before));
    __syncthreads();  // buffer k consumed
    if (warp == 0 && tl + stages < t_end) stage(tl + stages, k);
  }
}

// The largest unit (16, 8, 4, 2 or 1 bytes) that divides a row and the
// addresses of both windows, so every row's units are aligned.
int unit_of(int row_bytes, const void* a, const void* b) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(a) |
                      reinterpret_cast<uintptr_t>(b) | (uintptr_t)row_bytes;
  for (int u = 16; u > 1; u >>= 1)
    if (x % u == 0) return u;
  return 1;
}

template <typename BinT, bool kSet>
cudaError_t launch(Streams s, long long cnt, int F, int f, Rule rule,
                   int path, int nblocks, int rows, int stages,
                   long long tiles, int threads, int smem, int* counts,
                   unsigned long long* status, int* n_left,
                   cudaStream_t stream) {
  if (path == 0) {
    auto* kern = part_resident<BinT, kSet>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    void* args[] = {&s, &cnt, &F, &f, &rule, &rows, &counts, &n_left};
    return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                       dim3(nblocks), dim3(threads), args,
                                       (size_t)smem, stream);
  }
  part_column<BinT, kSet><<<(unsigned)tiles, kColumnThreads, 0, stream>>>(
      reinterpret_cast<const BinT*>(s.src[0]), cnt, F, f, rule, rows, status,
      n_left);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto* kern = part_move<BinT, kSet>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  kern<<<nblocks, threads, smem, stream>>>(s, cnt, F, f, rule, rows, stages,
                                           tiles, status, n_left);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block (the layout above), for the wrapper's
// plan to check against its own count.
extern "C" int partition_smem_bytes(int rows, int F, int bin_bytes,
                                    int pay_bytes, int stages) {
  return (int)layout(rows, F, bin_bytes, pay_bytes, stages).total;
}

template <typename BinT, bool kSet>
const void* kernel_of(int path) {
  return path == 0 ? reinterpret_cast<const void*>(part_resident<BinT, kSet>)
                   : reinterpret_cast<const void*>(part_move<BinT, kSet>);
}

// Blocks of `threads` threads and `smem` dynamic shared memory that one SM
// holds at once, by cudaOccupancyMaxActiveBlocksPerMultiprocessor: path 0
// part_resident, 1 part_move; the fewer of the range and membership
// rules' kernels. Negative: a CUDA error.
extern "C" int partition_occupancy(int bin_bytes, int path, int threads,
                                   int smem) {
  const void* ks[2] = {
      bin_bytes == 1 ? kernel_of<uint8_t, false>(path)
                     : kernel_of<uint16_t, false>(path),
      bin_bytes == 1 ? kernel_of<uint8_t, true>(path)
                     : kernel_of<uint16_t, true>(path)};
  int best = 1 << 30;
  for (const void* k : ks) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int n = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, threads, smem);
    if (e != cudaSuccess) return -(int)e;
    best = n < best ? n : best;
  }
  return best;
}

// 1 if the device supports cooperative launches (the resident path).
extern "C" int partition_cooperative(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrCooperativeLaunch, device) !=
      cudaSuccess)
    return 0;
  return v;
}

// Partition the window [0, cnt) of the source pointers into the
// destination pointers (each already offset to the window's first row),
// by the wrapper's plan: path 0, resident (nblocks blocks of `rows` rows,
// `counts` one int per block); path 1, streaming (`tiles` tiles of `rows`
// rows, `status` one zeroed 64-bit word per tile, left zeroed; nblocks
// move-pass blocks with a ring of `stages` buffers). pay_bytes is a
// payload row's width: 8 (f32 pair), 2 (int8 pair) or 0 (no payload;
// pay_* are then ignored). ids_* may be null. `n_left` receives the left
// count. Rows split on bin column f by the range rule (lo, hi, nan_pos,
// dl) above, or, when `bits` is not null, by the membership rule of its
// nbits bits. Returns the first CUDA error (0 = success).
extern "C" int partition_window(
    const void* bins_src, void* bins_dst, int bin_bytes, const void* pay_src,
    void* pay_dst, int pay_bytes, const void* ids_src, void* ids_dst,
    long long cnt, int F, int f, int lo, int hi, int nan_pos, int dl,
    const void* bits, int nbits, int path,
    int nblocks, int rows, int stages, long long tiles, int threads,
    int smem, void* counts, void* status, void* n_left, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* nl = static_cast<int*>(n_left);
  if (cnt <= 0) return (int)cudaMemsetAsync(nl, 0, sizeof(int), st);
  const bool resident = path == 0;
  const long long cover = resident ? (long long)nblocks * rows : tiles * rows;
  if (cnt > 0x7fffffffLL || f < 0 || f >= F ||
      (bin_bytes != 1 && bin_bytes != 2) ||
      (pay_bytes != 0 && pay_bytes != 2 && pay_bytes != 8) ||
      (pay_bytes != 0 && (pay_src == nullptr || pay_dst == nullptr)) ||
      (path != 0 && path != 1) || rows < 1 || rows > kMaxRows ||
      nblocks < 1 || threads < 32 || threads > 512 || threads % 32 != 0 ||
      cover < cnt || (resident && stages != 1) ||
      (!resident && (stages < 2 || stages > kMaxStages || tiles < 1 ||
                     tiles > 0x7fffffffLL || status == nullptr)) ||
      (resident && counts == nullptr) || (bits != nullptr && nbits < 1) ||
      smem != partition_smem_bytes(rows, F, bin_bytes, pay_bytes, stages))
    return (int)cudaErrorInvalidValue;
  Streams s;
  const void* srcs[3] = {bins_src, pay_bytes ? pay_src : nullptr, ids_src};
  void* dsts[3] = {bins_dst, pay_bytes ? pay_dst : nullptr, ids_dst};
  const int rbs[3] = {F * bin_bytes, pay_bytes, 4};
  for (int k = 0; k < 3; ++k) {
    const bool on = srcs[k] != nullptr && dsts[k] != nullptr;
    s.src[k] = on ? static_cast<const unsigned char*>(srcs[k]) : nullptr;
    s.dst[k] = on ? static_cast<unsigned char*>(dsts[k]) : nullptr;
    s.row_bytes[k] = rbs[k];
    s.unit[k] = on ? unit_of(rbs[k], srcs[k], dsts[k]) : 1;
  }
  const Rule rule{lo, hi, nan_pos, dl,
                  static_cast<const unsigned char*>(bits), nbits};
  int* c = static_cast<int*>(counts);
  unsigned long long* sw = static_cast<unsigned long long*>(status);
  if (bin_bytes == 1)
    return (int)(bits ? launch<uint8_t, true>(s, cnt, F, f, rule, path,
                                              nblocks, rows, stages, tiles,
                                              threads, smem, c, sw, nl, st)
                      : launch<uint8_t, false>(s, cnt, F, f, rule, path,
                                               nblocks, rows, stages, tiles,
                                               threads, smem, c, sw, nl, st));
  return (int)(bits ? launch<uint16_t, true>(s, cnt, F, f, rule, path,
                                             nblocks, rows, stages, tiles,
                                             threads, smem, c, sw, nl, st)
                    : launch<uint16_t, false>(s, cnt, F, f, rule, path,
                                              nblocks, rows, stages, tiles,
                                              threads, smem, c, sw, nl, st));
}
