// Online GAME scoring margins of one padded bucket — CUDA C++ for sm_90a.
//
// Replaces the XLA programs photon_ml_tpu/serving/kernels.py ::
// build_bucket_kernel and build_fused_bucket_kernel (the serving runtime's
// padded-bucket margin program; not a TPU kernel).  What it computes, for
// every row r of a bucket of n rows:
//
//     total = offset[r]
//     for each fixed coordinate i (in order):
//         total += sum over d of x_i[r, d] * w_i[d]
//     for each random coordinate j (in order):
//         total += sum over d of x_j[r, d] * (table_j[slot_j[r], d] + cold_j[r, d])
//     out[0, r] = total,  out[1, r] = mean_link(total)
//
// The contract the serving runtime pins is bitwise: a row's score must not
// depend on the bucket it was padded into or on its batch-mates (batched ==
// single), on whether its entity was hot or cold (one of table[slot] and
// cold is the zero row, so their sum is exact), or on the fused or composed
// argument layout.  A library reduction (torch.sum, a GEMV) picks its
// blocking and split from the number of output rows, so its summation
// order changes with the bucket.  Here the order depends only on each
// coordinate's width: one warp a row, lane l sums the columns d = l, l+32,
// l+64, ... in increasing d, then a fixed xor-shuffle tree (16, 8, 4, 2, 1)
// adds the 32 lane sums, and each coordinate's sum is formed before it is
// added to the total.  Every add and multiply is an explicit
// round-to-nearest intrinsic, so nvcc contracts nothing into an FMA, and
// serving/kernels.py's plain version (the same order in torch ops) gives
// the same bits.
//
// The layout: every feature block is a row-strided view (row stride given,
// columns contiguous), so the fused packed buffer
// (offset | fixed blocks | (features, cold) per random coordinate) and the
// composed per-coordinate arrays are both just pointers and strides into
// the same kernel.
//
// Bound on this card: launches.  A 64-row bucket of phase 7's model moves
// ~140 KB (a few hundred ns at 3.35 TB/s); the launch itself costs more.
//
// Interface: plain C functions called through ctypes.  The launch runs on
// the caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().  Slots must lie in [0, rows of the table) (the
// runtime's LRU guarantees it; checking on the card would need a read-back).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxFixed = 8;
constexpr int kMaxRandom = 8;
constexpr int kWarpsPerBlock = 4;
constexpr int kWarp = 32;

enum Link : int { kIdentity = 0, kLogistic = 1, kExp = 2 };

struct Coords {
  const float* offset;
  long long offset_stride;
  int n_fixed;
  int n_random;
  int link;
  long long n;
  float* out;  // (2, n): margins then means
  const float* fx[kMaxFixed];
  long long fx_stride[kMaxFixed];
  const float* fw[kMaxFixed];
  int fd[kMaxFixed];
  const float* rx[kMaxRandom];
  long long rx_stride[kMaxRandom];
  const float* rcold[kMaxRandom];
  long long rcold_stride[kMaxRandom];
  const float* rtable[kMaxRandom];
  const int32_t* rslot[kMaxRandom];
  int rd[kMaxRandom];
};

// The 32 lane sums added by a fixed butterfly: every lane ends with the
// same bits (a + b == b + a in IEEE arithmetic).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float mean_link(float m, int link) {
  if (link == kLogistic) {
    // The numerically stable split of the reference's host mean link.
    if (m >= 0.0f) return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-m)));
    const float e = expf(m);
    return __fdiv_rn(e, __fadd_rn(1.0f, e));
  }
  if (link == kExp) return expf(m);
  return m;
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
serve_margins_kernel(const Coords c) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= c.n) return;  // whole warps leave together
  float total = c.offset[row * c.offset_stride];
  for (int i = 0; i < c.n_fixed; ++i) {
    const float* x = c.fx[i] + row * c.fx_stride[i];
    const float* w = c.fw[i];
    float acc = 0.0f;
    for (int d = lane; d < c.fd[i]; d += kWarp) {
      acc = __fadd_rn(acc, __fmul_rn(x[d], w[d]));
    }
    total = __fadd_rn(total, warp_sum(acc));
  }
  for (int j = 0; j < c.n_random; ++j) {
    const int dim = c.rd[j];
    const float* x = c.rx[j] + row * c.rx_stride[j];
    const float* cold = c.rcold[j] + row * c.rcold_stride[j];
    const float* hot =
        c.rtable[j] + static_cast<long long>(c.rslot[j][row]) * dim;
    float acc = 0.0f;
    for (int d = lane; d < dim; d += kWarp) {
      acc = __fadd_rn(acc, __fmul_rn(x[d], __fadd_rn(hot[d], cold[d])));
    }
    total = __fadd_rn(total, warp_sum(acc));
  }
  if (lane == 0) {
    c.out[row] = total;
    c.out[c.n + row] = mean_link(total, c.link);
  }
}

}  // namespace

extern "C" {

// Returns 0 on a clean launch, else the cudaError_t code
// (cudaErrorInvalidValue for more coordinates than the kernel holds or a
// negative count).  The pointer and stride arrays are host arrays of
// n_fixed / n_random entries; strides are in floats.
int photon_serve_margins(const void* offset, long long offset_stride,
                         int n_fixed, const void* const* fx,
                         const long long* fx_stride, const void* const* fw,
                         const int* fd, int n_random, const void* const* rx,
                         const long long* rx_stride, const void* const* rcold,
                         const long long* rcold_stride,
                         const void* const* rtable, const void* const* rslot,
                         const int* rd, int link, void* out, long long n,
                         void* stream) {
  if (n_fixed < 0 || n_fixed > kMaxFixed || n_random < 0 ||
      n_random > kMaxRandom || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Coords c{};
  c.offset = static_cast<const float*>(offset);
  c.offset_stride = offset_stride;
  c.n_fixed = n_fixed;
  c.n_random = n_random;
  c.link = link;
  c.n = n;
  c.out = static_cast<float*>(out);
  for (int i = 0; i < n_fixed; ++i) {
    c.fx[i] = static_cast<const float*>(fx[i]);
    c.fx_stride[i] = fx_stride[i];
    c.fw[i] = static_cast<const float*>(fw[i]);
    c.fd[i] = fd[i];
  }
  for (int j = 0; j < n_random; ++j) {
    c.rx[j] = static_cast<const float*>(rx[j]);
    c.rx_stride[j] = rx_stride[j];
    c.rcold[j] = static_cast<const float*>(rcold[j]);
    c.rcold_stride[j] = rcold_stride[j];
    c.rtable[j] = static_cast<const float*>(rtable[j]);
    c.rslot[j] = static_cast<const int32_t*>(rslot[j]);
    c.rd[j] = rd[j];
  }
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  serve_margins_kernel<<<static_cast<unsigned>(blocks),
                         kWarpsPerBlock * kWarp, 0,
                         static_cast<cudaStream_t>(stream)>>>(c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
