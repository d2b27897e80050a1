// Shared by every kernel library of the port (each .cu is built alone into
// its own shared library, so each library gets one copy of these).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace photon {

// -- mbarriers and bulk copies (sm_90) ---------------------------------------

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbarrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   shared_address(bar))
               : "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint64_t* bar,
                                                          uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}

// A wait on an mbarrier that lasts this long (ns) cannot end: a broken ring.
constexpr uint64_t kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

// Spins until the phase of parity `parity` of `bar` has completed.  A wait
// past kWaitLimitNs of the global timer traps, so the launch fails with an
// error instead of hanging the card.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t at = shared_address(bar);
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(at), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (start == 0) {
      start = now;
    } else if (now - start > kWaitLimitNs) {
      __trap();
    }
  }
}

// One bulk asynchronous copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy_to_shared(void* dst, const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

// A ring of kStages shared-memory stages that one producer thread fills with
// bulk copies and consumer warps drain.  Stage s has a "full" barrier (one
// arrival, the producer's arrive.expect_tx; its phase completes when the
// stage's bytes have landed) and an "empty" barrier (one arrival per
// consumer warp once the warp has read the stage).  Producer and consumers
// each walk the stages in order with their own RingCursor, whose phase bit
// flips every lap: a consumer waits for full[s] to complete the phase of its
// lap, the producer for empty[s] to complete the phase of the lap before
// (on its first lap that wait passes at once: the stages start empty).
template <int kStages>
struct Ring {
  uint64_t full[kStages];
  uint64_t empty[kStages];

  // One thread, followed by a barrier of the whole CTA.
  __device__ void init(unsigned consumer_warps) {
    for (int s = 0; s < kStages; ++s) {
      mbarrier_init(&full[s], 1);
      mbarrier_init(&empty[s], consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
};

struct RingCursor {
  int stage = 0;
  uint32_t phase = 0;

  template <int kStages>
  __device__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// Producer: wait until stage cur.stage is free, then announce `bytes` on its
// full barrier; the caller starts bulk copies totalling `bytes` onto
// ring.full[cur.stage] and advances the cursor.
template <int kStages>
__device__ __forceinline__ void ring_produce(Ring<kStages>& ring,
                                             const RingCursor& cur,
                                             uint32_t bytes) {
  mbarrier_wait(&ring.empty[cur.stage], cur.phase ^ 1u);
  mbarrier_arrive_expect_tx(&ring.full[cur.stage], bytes);
}

// Consumer warp: wait until stage cur.stage holds this lap's bytes.
template <int kStages>
__device__ __forceinline__ void ring_consume(Ring<kStages>& ring,
                                             const RingCursor& cur) {
  mbarrier_wait(&ring.full[cur.stage], cur.phase);
}

// Consumer warp, every lane: the warp has read stage cur.stage; hand it back
// to the producer (one arrival per warp).
template <int kStages>
__device__ __forceinline__ void ring_release(Ring<kStages>& ring,
                                             const RingCursor& cur) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbarrier_arrive(&ring.empty[cur.stage]);
}

// -- host side ---------------------------------------------------------------

// Opts one kernel into dynamic shared memory above the default 48 KB, where
// a launch is otherwise refused ("invalid argument").  Keep one static
// instance per kernel: the attribute is set once per device and only ever
// raised, so later launches (inside a CUDA-graph capture too) make no
// runtime call here.
struct SharedMemoryOptIn {
  static constexpr int kDefaultLimit = 48 * 1024;
  static constexpr int kMaxDevices = 64;
  int configured[kMaxDevices] = {};

  cudaError_t ensure(const void* kernel, int bytes) {
    if (bytes <= kDefaultLimit) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices && configured[dev] >= bytes) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = bytes;
    return err;
  }
};

// The most dynamic shared memory one block may opt into on the current
// device (227 KB on an H100), or -1 when the query fails.
inline int max_shared_memory_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

}  // namespace photon

extern "C" const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
