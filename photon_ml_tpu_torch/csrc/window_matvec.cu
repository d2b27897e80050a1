// Mat-vec over the v2 window layout — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel experiments/exp_g8192_v2.py::make_matvec (its
// pl.pallas_call over matvec_kernel).  The layout, built on the host by
// photon_ml_tpu_torch/experiments/g8192_v2.py::build_layout, packs each
// 8192-row block b into slots (b, a, l): lane l = row % 128, sublane
// a = window * 64 + depth, where window = column // 128.  Each slot holds
// lo = column % 128, v = the value and rhi = (row % 8192) // 128; padded
// slots hold lo = 0, v = 0, rhi = 0, exactly as the reference's do, and are
// summed like any other slot, as the reference sums them.
//
// What it computes, for every block b, row group h in [0, 64), lane l:
//
//     out[b, h, l] = sum over a with rhi[b, a, l] == h of
//                    v[b, a, l] * w[(a / 64) * 128 + lo[b, a, l]]
//
// so out[b, h, l] is the margin of row b * 8192 + h * 128 + l.  lo must lie
// in [0, 128) and rhi in [0, 64) (build_layout's guarantee).  No atomics:
// the sum order is fixed, so two runs are bitwise equal.
//
// Bound on this card: bytes.  The three slot arrays are read once:
// 3 x 4 B x 128 x 4096 x 128 = 805 MB at 2^20 rows, 0.2416 ms at 3.35 TB/s,
// about three times the 0.0814 ms that the live entries alone would need
// (the layout fills about half its slots, and each carries rhi as well).
//
// Design: one CTA per (block b, slice of 32 lanes): 128 x 4 = 512 CTAs of
// 256 threads = 32 lanes x 8 sublane slices.  w (32 KB) is staged in shared
// memory; thread (s, l) walks sublanes [512 s, 512 s + 512), reads
// lo/v/rhi[b, a, lane] (32 consecutive lanes: one 128-byte load each),
// gathers from shared w and adds into acc[s][rhi][l] in shared memory.
// That column of acc belongs to this thread alone, so there is no race.
// After a barrier the 8 slices are summed in a fixed order into
// out[b, h, lane].  Shared memory: 32 KB + 8 x 64 x 32 x 4 B = 96 KB, which
// needs the dynamic shared memory opt-in.
//
// Interface: plain C functions called through ctypes.  The launch runs on
// the caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kWindows = 64;                    // W: column windows of 128
constexpr int kDepth = 64;                      // DEPTH: slots per cell
constexpr int kSublanes = kWindows * kDepth;    // A = 4096
constexpr int kLanes = 128;
constexpr int kDim = kWindows * kLanes;         // D = 8192
constexpr int kLanesPerCta = 32;
constexpr int kSlices = 8;
constexpr int kThreads = kLanesPerCta * kSlices;  // 256
constexpr int kSublanesPerSlice = kSublanes / kSlices;  // 512
constexpr int kCtasPerBlock = kLanes / kLanesPerCta;    // 4
constexpr int kAccFloats = kSlices * kWindows * kLanesPerCta;
constexpr int kSharedBytes =
    (kDim + kAccFloats) * static_cast<int>(sizeof(float));  // 96 KB

__global__ void __launch_bounds__(kThreads)
window_matvec_kernel(const int32_t* __restrict__ lo,
                     const float* __restrict__ v,
                     const int32_t* __restrict__ rhi,
                     const float* __restrict__ w,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  float* w_s = smem;                // (kDim,)
  float* acc = smem + kDim;         // (kSlices, kWindows, kLanesPerCta)
  const int b = blockIdx.x / kCtasPerBlock;
  const int lane0 = (blockIdx.x % kCtasPerBlock) * kLanesPerCta;
  const int l = threadIdx.x % kLanesPerCta;
  const int s = threadIdx.x / kLanesPerCta;

  for (int i = threadIdx.x; i < kDim; i += kThreads) w_s[i] = w[i];
  float* mine = acc + s * kWindows * kLanesPerCta + l;
  for (int h = 0; h < kWindows; ++h) mine[h * kLanesPerCta] = 0.0f;
  __syncthreads();

  const int64_t base =
      static_cast<int64_t>(b) * kSublanes * kLanes + lane0 + l;
  const int a0 = s * kSublanesPerSlice;
  for (int a = a0; a < a0 + kSublanesPerSlice; ++a) {
    const int64_t at = base + static_cast<int64_t>(a) * kLanes;
    const float g = w_s[(a / kDepth) * kLanes + lo[at]];
    mine[rhi[at] * kLanesPerCta] += v[at] * g;
  }
  __syncthreads();

  for (int o = threadIdx.x; o < kWindows * kLanesPerCta; o += kThreads) {
    const int h = o / kLanesPerCta;
    const int ll = o % kLanesPerCta;
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < kSlices; ++t) {
      sum += acc[(t * kWindows + h) * kLanesPerCta + ll];
    }
    out[(static_cast<int64_t>(b) * kWindows + h) * kLanes + lane0 + ll] = sum;
  }
}

photon::SharedMemoryOptIn g_opt_in;

}  // namespace

extern "C" {

// Returns 0 on a clean launch, else the cudaError_t code.  lo, v and rhi are
// (n_blocks, 4096, 128), w is (8192,), out is (n_blocks, 64, 128);
// n_blocks must be positive.
int photon_window_matvec(const void* lo, const void* v, const void* rhi,
                         const void* w, void* out, long long n_blocks,
                         void* stream) {
  const cudaError_t err = g_opt_in.ensure(
      reinterpret_cast<const void*>(window_matvec_kernel), kSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = n_blocks * kCtasPerBlock;
  window_matvec_kernel<<<static_cast<unsigned int>(blocks), kThreads,
                         kSharedBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lo), static_cast<const float*>(v),
      static_cast<const int32_t*>(rhi), static_cast<const float*>(w),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
