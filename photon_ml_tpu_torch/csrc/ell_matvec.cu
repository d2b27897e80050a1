// ELL mat-vec from a table held in shared memory — CUDA C++ for sm_90a.
//
// Replaces the TPU kernels experiments/exp_g8192.py::pallas_matvec and
// main.pallas_matvec_inner (the same kernel body, matvec_kernel, inside a
// chained fori_loop).  Those gather 33.5M values from the 8192-wide w with a
// 64-window take_along_axis sweep, because Mosaic's only fast gather is a
// 128-lane dynamic_gather.  An H100 SM gathers from shared memory directly,
// and w (8192 x 4 B = 32 KB) fits there, so the sweep is gone.
//
// What it computes, for every row r in [0, n):
//
//     m[r] = sum over j in [0, k) of vals_T[j, r] * w[cols_T[j, r]]
//
// over the transposed ELL arrays cols_T / vals_T of shape (k, n), summed in
// order j = 0, 1, ..., k-1.  No atomics, so two runs are bitwise equal.
// cols_T must lie in [0, d) (make_ell's guarantee; checking it on the
// card would need a read-back).
//
// Bound on this card: bytes.  At n = 2^20, k = 32, d = 8192 the two ELL
// arrays are 268 MB, m 4 MB and w 32 KB: 0.0814 ms at 3.35 TB/s.  The
// arithmetic (2 flops an entry) is far below the f32 peak.
//
// Design: a persistent grid of 2 CTAs per SM.  Each CTA copies w into shared
// memory once, then walks a grid-stride range of rows, one thread a row:
// thread r reads cols_T[j*n + r] and vals_T[j*n + r], so consecutive threads
// read consecutive addresses, and the gather hits shared memory.  One CTA
// per 256 rows instead would re-stage w 4096 times (134 MB from L2).
//
// Interface: plain C functions called through ctypes.  The launch runs on
// the caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kCtasPerSm = 2;

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
ell_matvec_kernel(const int32_t* __restrict__ cols_T,
                  const float* __restrict__ vals_T,
                  const float* __restrict__ w,
                  float* __restrict__ m,
                  int64_t n, int k, int d) {
  extern __shared__ float w_s[];
  for (int i = threadIdx.x; i < d; i += kThreads) w_s[i] = w[i];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < n; r += stride) {
    float acc = 0.0f;
#pragma unroll 8
    for (int j = 0; j < k; ++j) {
      const int64_t at = static_cast<int64_t>(j) * n + r;
      acc += vals_T[at] * w_s[cols_T[at]];
    }
    m[r] = acc;
  }
}

photon::SharedMemoryOptIn g_opt_in;

}  // namespace

extern "C" {

// The widest w (in floats) one CTA can hold in shared memory on the current
// device, or -1 when the device query fails.
int photon_ell_max_dim() {
  const int bytes = photon::max_shared_memory_optin();
  return bytes < 0 ? -1 : bytes / static_cast<int>(sizeof(float));
}

// Returns 0 on a clean launch, else the cudaError_t code.  n and d must be
// positive, k non-negative, and d at most photon_ell_max_dim().
int photon_ell_matvec(const void* cols_T, const void* vals_T, const void* w,
                      void* m, long long n, int k, int d, void* stream) {
  const int smem = d * static_cast<int>(sizeof(float));
  cudaError_t err = g_opt_in.ensure(
      reinterpret_cast<const void*>(ell_matvec_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed = (n + kThreads - 1) / kThreads;
  const long long persistent = static_cast<long long>(sms) * kCtasPerSm;
  const int blocks = static_cast<int>(needed < persistent ? needed
                                                          : persistent);
  ell_matvec_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols_T), static_cast<const float*>(vals_T),
      static_cast<const float*>(w), static_cast<float*>(m), n, k, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
