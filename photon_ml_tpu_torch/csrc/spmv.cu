// CSR sparse mat-vec for the GLM hot loop — CUDA C++ for sm_90a (H100).
//
// Replaces the TPU kernel photon_ml_tpu/ops/sparse_pallas.py::_tile_kernel
// (launched by _tiled_apply's pl.pallas_call).  That kernel streams a
// window-packed (tile, sublane, lane) slot grid because Mosaic's only fast
// gather is a 128-lane dynamic_gather; a GPU gathers from L1/L2 directly, so
// the layout here is plain CSR with no slot grid, no depth cap and no spill.
//
// What it computes, for every output r in [0, n_out):
//
//     y[r] = sum over k in [indptr[r], indptr[r+1]) of f(val[k]) * x[idx[k]]
//
// with f(v) = v, or v*v under SQUARE, or 1 under UNIT (binary matrices: no
// value stream at all, 4 bytes per entry instead of 8).  The same kernel
// serves both orientations of the port's matrix: on the row-major CSR it is
// matvec (Xw) / row_sq_matvec ((X⊙X)v); on the CSC copy built on the host
// (the CSR of Xᵀ) it is rmatvec (Xᵀu) / sq_rmatvec ((X⊙X)ᵀu).  No atomics:
// each output is summed by one warp in a fixed order (lane-strided partial
// sums, then a fixed __shfl_down_sync tree), so two runs are bitwise equal.
// Only live entries are stored (zero values are dropped at build time and
// segments hold no padding), so a non-finite x[j] reaches exactly the
// outputs whose segments hold j.  An empty segment writes 0.
//
// Bound on this card: bytes.  At 2^20 rows x 8192 features with 32 nnz a
// row, the valued stream is 33.5M x (4 B index + 4 B value) ≈ 268 MB
// (≈ 134 MB in UNIT mode), ≈ 80 µs (≈ 40 µs) at 3.35 TB/s; the arithmetic
// (2 flops per entry) is three orders of magnitude below the f32 peak.
//
// Design: the simplest one that is right — one warp per output element,
// lanes striding the segment with coalesced index/value loads and a gathered
// read of x.  A long segment (a hot column just under the dense-stripe
// threshold) is one warp's serial work; balancing such segments and
// vectorising the loads are later work (ROADMAP.md).
//
// Ablations (the counterpart of experiments/exp_ablate.py's modes, valued
// layout only): MODE takes parts of the FULL loop away to show what each
// costs.  NOGATHER reads x at x[k mod n_in], an address that does not depend
// on the index (consecutive lanes, consecutive addresses); STREAM reads no x
// at all and sums the values.  Both still load idx[k] and keep it live: a
// negative index would turn the value into NaN, so nvcc cannot drop the load
// and the mode streams the bytes it claims to.  photon_spmv launches only
// FULL; photon_spmv_ablate launches any mode.
//
// Interface: plain C functions, built with nvcc into a shared library and
// called through ctypes.  They launch on the caller's stream, do not
// synchronise, allocate nothing, and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

constexpr int kFull = 0;
constexpr int kNoGather = 1;
constexpr int kStream = 2;

template <int MODE, bool UNIT, bool SQUARE>
__global__ void __launch_bounds__(kThreads)
spmv_warp_kernel(const int64_t* __restrict__ indptr,
                 const int32_t* __restrict__ idx,
                 const float* __restrict__ val,
                 const float* __restrict__ x,
                 float* __restrict__ y,
                 int64_t n_out,
                 int64_t n_in) {
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_out) return;  // whole warp leaves together
  const int64_t start = indptr[warp];
  const int64_t end = indptr[warp + 1];
  float acc = 0.0f;
  if constexpr (MODE == kFull) {
    for (int64_t k = start + lane; k < end; k += 32) {
      const float xv = __ldg(x + idx[k]);
      if (UNIT) {
        acc += xv;
      } else {
        const float v = val[k];
        acc += (SQUARE ? v * v : v) * xv;
      }
    }
  } else {
    static_assert(!UNIT && !SQUARE, "ablations run on the valued layout");
    int64_t kx = (start + lane) % n_in;  // k mod n_in, kept incrementally
    for (int64_t k = start + lane; k < end; k += 32) {
      float v = val[k];
      v = (idx[k] < 0) ? __int_as_float(0x7fc00000) : v;  // keeps idx live
      if constexpr (MODE == kNoGather) {
        acc += v * __ldg(x + kx);
        kx += 32;
        while (kx >= n_in) kx -= n_in;
      } else {
        acc += v;
      }
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) y[warp] = acc;
}

template <int MODE, bool UNIT, bool SQUARE>
void launch(const int64_t* indptr, const int32_t* idx, const float* val,
            const float* x, float* y, int64_t n_out, int64_t n_in,
            cudaStream_t stream) {
  const int64_t blocks = (n_out + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmv_warp_kernel<MODE, UNIT, SQUARE>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          indptr, idx, val, x, y, n_out, n_in);
}

}  // namespace

extern "C" {

// Returns 0 on a clean launch, else the cudaError_t code.  n_out must be
// positive and below 2^31 * 8 outputs (one grid dimension of warps).
int photon_spmv(const void* indptr, const void* idx, const void* val,
                const void* x, void* y, long long n_out, int unit,
                int square, void* stream) {
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* v = static_cast<const float*>(val);
  const auto* xv = static_cast<const float*>(x);
  auto* yv = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (unit) {
    launch<kFull, true, false>(ip, ix, v, xv, yv, n_out, 0, s);
  } else if (square) {
    launch<kFull, false, true>(ip, ix, v, xv, yv, n_out, 0, s);
  } else {
    launch<kFull, false, false>(ip, ix, v, xv, yv, n_out, 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The valued, unsquared kernel with parts taken away: mode 0 FULL (the
// production instance), 1 NOGATHER, 2 STREAM.  n_in (the length of x) must
// be positive.  An unknown mode returns cudaErrorInvalidValue unlaunched.
int photon_spmv_ablate(int mode, const void* indptr, const void* idx,
                       const void* val, const void* x, void* y,
                       long long n_out, long long n_in, void* stream) {
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* v = static_cast<const float*>(val);
  const auto* xv = static_cast<const float*>(x);
  auto* yv = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull:
      launch<kFull, false, false>(ip, ix, v, xv, yv, n_out, n_in, s);
      break;
    case kNoGather:
      launch<kNoGather, false, false>(ip, ix, v, xv, yv, n_out, n_in, s);
      break;
    case kStream:
      launch<kStream, false, false>(ip, ix, v, xv, yv, n_out, n_in, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
