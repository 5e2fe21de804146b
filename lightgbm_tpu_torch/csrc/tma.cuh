// Staging of row tiles into shared memory by TMA bulk copies, shared by
// K1 (hist.cu) and K2 (partition.cu).
//
// One elected warp starts the copy of a byte range of device memory into a
// shared-memory slot: the range's 16-byte-aligned middle by
// cp.async.bulk, completing on an mbarrier, and the <= 15 ragged bytes at
// each end by plain loads and stores of its lanes. Byte i of the range
// lands at slot[(g mod 16) + i], so a slot needs 16 bytes of slack and a
// row keeps its source's alignment mod 16.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(saddr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(saddr(bar)),
               "r"(tx)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// The 16-byte-aligned middle [a, z) of the byte range [g, g + n).
__device__ __forceinline__ uint32_t body_bytes(const unsigned char* g,
                                               uint32_t n) {
  const uintptr_t a = (reinterpret_cast<uintptr_t>(g) + 15) & ~uintptr_t(15);
  const uintptr_t z = (reinterpret_cast<uintptr_t>(g) + n) & ~uintptr_t(15);
  return z > a ? (uint32_t)(z - a) : 0u;
}

// Warp 0 starts the copy of [g, g + n) into `slot`, byte i landing at
// slot[(g mod 16) + i]: lane 0 issues the bulk copy of the aligned middle
// (the barrier was armed with its bytes), lanes 0-14 copy the head and
// lanes 16-30 the tail. A range with no aligned middle is at most 30
// bytes, copied by lanes 0-29.
__device__ __forceinline__ void stage_stream(const unsigned char* g,
                                             uint32_t n, unsigned char* slot,
                                             uint64_t* bar, int lane) {
  const uintptr_t gs = reinterpret_cast<uintptr_t>(g);
  const uintptr_t a = (gs + 15) & ~uintptr_t(15);
  const uintptr_t z = (gs + n) & ~uintptr_t(15);
  unsigned char* d = slot + (gs & 15);
  if (z > a) {
    const int head = (int)(a - gs);
    const int tail = (int)(gs + n - z);
    if (lane == 0) bulk_copy(d + head, reinterpret_cast<const void*>(a),
                             (uint32_t)(z - a), bar);
    if (lane < head) {
      d[lane] = g[lane];
    } else if (lane >= 16 && lane - 16 < tail) {
      const int i = (int)(z - gs) + lane - 16;
      d[i] = g[i];
    }
  } else if (lane < (int)n) {
    d[lane] = g[lane];
  }
}

}  // namespace
