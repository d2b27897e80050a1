// The GLM's sparse mat-vecs — CUDA C++ for sm_90a (H100).
//
// Replaces the TPU kernel photon_ml_tpu/ops/sparse_pallas.py::_tile_kernel
// (launched by _tiled_apply's pl.pallas_call).  That kernel streams a
// window-packed (tile, sublane, lane) slot grid because Mosaic's only fast
// gather is a 128-lane dynamic_gather.  A GPU gathers from its caches and
// shared memory directly, so the port keeps plain CSR for the row side and a
// host-built CSC copy for the column side, each with its own kernel.
//
// What they compute, with f(v) = v, or v*v under SQUARE, or 1 under UNIT
// (binary matrices: no value stream, 4 bytes an entry instead of 8):
//
//   spmv_rows_kernel (matvec Xw, row_sq_matvec (X⊙X)v), on the CSR:
//       y[r] = sum over k in [indptr[r], indptr[r+1]) of f(val[k]) * x[idx[k]]
//   spmv_cols_kernel + spmv_combine_kernel (rmatvec Xᵀu, sq_rmatvec
//   (X⊙X)ᵀu), on the CSC copy cut into row blocks of kRowBlock rows:
//       partial[t, j] = sum over k in [bp[j, t], bp[j, t+1]) of
//                           f(val[k]) * x[idx[k]]
//       y[j] = partial[0, j] + partial[1, j] + ... + partial[n_rb-1, j]
//   where bp = blockptr (n_cols x (n_rb + 1)): bp[j, t] is the first entry
//   of column j whose row is >= t * kRowBlock (rows ascend in a column).
//
// No atomics: every lane sums its entries in a fixed order, a fixed shuffle
// tree combines the lanes, and the combine kernel adds the row blocks in t
// order, so two launches are bitwise equal.  Only live entries are stored
// (zeros are dropped at build time, segments hold no padding), so a
// non-finite x[i] reaches exactly the outputs whose segments hold i.  An
// empty segment writes 0.
//
// Bound on this card: bytes.  At 2^20 rows x 8192 features with 32 nnz a
// row the valued stream is 33.5M x (4 B index + 4 B value) = 268 MB (134 MB
// in UNIT mode): 80 µs (40 µs) at 3.35 TB/s.  The arithmetic (2 flops an
// entry) is three orders of magnitude below the f32 peak.
//
// Row kernel: G lanes a row (G in {4, 8, 16, 32}, picked on the host from
// the mean row length; G = 8 for 32-entry rows, so a warp sums 4 rows at a
// time).  A persistent grid, sized from the SM count and the occupancy,
// strides over groups of rows; each warp reads the indptr boundaries of its
// rows in one coalesced load (the next group's while it sums this one) and
// hands them out by shuffle.  Each lane issues kRowUnroll index/value loads,
// then their x gathers, then the adds.  x stays in global memory and is read
// through __ldg: 8192 features are 32 KB and stay in L1/L2.
//
// Column kernel: one CTA (1024 threads) per (row block t, column range).
// The CTA stages x[t*R, (t+1)*R) (the u of rmatvec; R = 2^15 rows, 128 KB)
// in shared memory with one bulk asynchronous copy (cp.async.bulk,
// completion on an mbarrier).  Then G lanes sum each column sub-range
// [bp[j, t], bp[j, t+1]) with kColUnroll coalesced index/value loads in
// flight a lane and the gather from shared memory, a warp 32/G sub-ranges at
// a time (G from the entry-weighted mean sub-range length, at most 16; 16
// for the ~128-entry sub-ranges of 2^20 rows x 8192 columns), and write
// partial[t, j].  A column range is every n_ranges-th column (interleaved,
// so a skewed column head spreads over every range); n_ranges is the number
// of CTAs the card holds at once divided by n_rb, so the grid is one wave.
// Each range stages the whole of x once: n_ranges x 4 B x n_rows from L2.
// A long column is cut into n_rb sub-ranges by the blocks themselves.  With
// one row block the column kernel writes y directly and nothing combines.
// R and the host's rule for G were chosen by measurement
// (experiments/row_block.py builds the library with -DPHOTON_SPMV_ROW_BLOCK
// at each candidate R and times rmatvec at every G).
//
// Ablations (the counterpart of experiments/exp_ablate.py's modes, valued
// layout only): MODE takes parts of the FULL loop away to show what each
// costs.  NOGATHER reads x at x[k mod n_in], an address that does not depend
// on the index (k is the entry's position in idx; the column kernel then
// stages nothing); STREAM reads no x at all and sums the values.  Both still
// load idx[k] and keep it live: a negative index would turn the value into
// NaN, so nvcc cannot drop the load and the mode streams the bytes it claims
// to.  Production launches pass mode 0 (FULL).
//
// Interface: plain C functions, built with nvcc into a shared library and
// called through ctypes.  They launch on the caller's stream, do not
// synchronise, allocate nothing, and return a cudaError_t code.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "common.cuh"

#ifndef PHOTON_SPMV_ROW_BLOCK
#define PHOTON_SPMV_ROW_BLOCK (1 << 15)
#endif

namespace {

constexpr unsigned kAll = 0xffffffffu;
// Index/value loads in flight per lane: the row kernel's, the column
// kernel's.
constexpr int kRowUnroll = 4;
constexpr int kColUnroll = 8;

constexpr int kFull = 0;
constexpr int kNoGather = 1;
constexpr int kStream = 2;

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;

constexpr int kRowBlock = PHOTON_SPMV_ROW_BLOCK;
static_assert(kRowBlock % 4 == 0, "row blocks are staged in 16-byte units");
constexpr int kColThreads = 1024;
constexpr int kColWarps = kColThreads / 32;
// Two CTAs an SM when two row blocks fit in shared memory (227 KB).
constexpr int kColCtasPerSm = 2 * kRowBlock * 4 <= 227 * 1024 ? 2 : 1;

// This lane's sum over its entries k, k + STEP, k + 2*STEP, ... < end, in
// that order, with U index/value loads in flight.  gather(c) reads x at
// index c in FULL mode.
template <int STEP, int U, int MODE, bool UNIT, bool SQUARE, class Gather>
__device__ __forceinline__ float lane_sum(const int32_t* __restrict__ idx,
                                          const float* __restrict__ val,
                                          const float* __restrict__ x,
                                          int64_t n_in, int64_t k, int64_t end,
                                          Gather gather) {
  static_assert(MODE == kFull || (!UNIT && !SQUARE),
                "ablations run on the valued layout");
  float acc = 0.0f;
  int64_t kx = 0;  // k mod n_in, kept incrementally (NOGATHER)
  if (MODE == kNoGather && k < end) kx = k % n_in;
  for (; k < end; k += STEP * U) {
    int32_t c[U];
    float v[U];
    float xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t ku = k + u * STEP;
      c[u] = ku < end ? __ldcs(idx + ku) : 0;
      v[u] = (UNIT || ku >= end) ? 1.0f : __ldcs(val + ku);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = k + u * STEP < end;
      if constexpr (MODE == kFull) {
        xv[u] = live ? gather(c[u]) : 0.0f;
      } else if constexpr (MODE == kNoGather) {
        xv[u] = live ? __ldg(x + kx) : 0.0f;
        kx += STEP;
        while (kx >= n_in) kx -= n_in;
      } else {
        xv[u] = 1.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u * STEP >= end) continue;
      if constexpr (MODE == kFull) {
        acc += UNIT ? xv[u] : (SQUARE ? v[u] * v[u] : v[u]) * xv[u];
      } else {
        const float vu = c[u] < 0 ? __int_as_float(0x7fc00000) : v[u];
        acc += MODE == kNoGather ? vu * xv[u] : vu;
      }
    }
  }
  return acc;
}

template <int G, int MODE, bool UNIT, bool SQUARE>
__global__ void __launch_bounds__(kRowThreads)
spmv_rows_kernel(const int64_t* __restrict__ indptr,
                 const int32_t* __restrict__ idx,
                 const float* __restrict__ val,
                 const float* __restrict__ x,
                 float* __restrict__ y,
                 int64_t n_out, int64_t n_in) {
  constexpr int kRows = 32 / G;  // rows a warp sums at a time
  const int lane = threadIdx.x & 31;
  const int g = lane / G;  // this lane's row within the warp's group
  const int l = lane % G;  // its place among the row's G lanes
  const int64_t step = static_cast<int64_t>(gridDim.x) * kRowWarps * kRows;
  int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kRowWarps + threadIdx.x / 32) * kRows;
  // Lanes 0..kRows hold indptr[base + lane]: the group's kRows + 1 bounds.
  auto bounds = [&](int64_t b) -> int64_t {
    return (lane <= kRows && b < n_out && b + lane <= n_out) ? indptr[b + lane]
                                                             : 0;
  };
  int64_t bnd = bounds(base);
  for (; base < n_out; base += step) {  // warp-uniform
    const int64_t start = __shfl_sync(kAll, bnd, g);
    const int64_t stop = __shfl_sync(kAll, bnd, g + 1);
    bnd = bounds(base + step);  // the next group's, in flight meanwhile
    const bool live = base + g < n_out;
    float acc = lane_sum<G, kRowUnroll, MODE, UNIT, SQUARE>(
        idx, val, x, n_in, start + l, live ? stop : start,
        [&](int32_t c) { return __ldg(x + c); });
#pragma unroll
    for (int offset = G / 2; offset > 0; offset >>= 1) {
      acc += __shfl_down_sync(kAll, acc, offset, G);
    }
    if (l == 0 && live) y[base + g] = acc;
  }
}

// Copies count floats from src to shared memory at dst: the 16-byte-aligned
// bulk through one cp.async.bulk that completes on the mbarrier at bar, the
// rest (a tail of < 4, or all of it when src is not 16-byte aligned) by the
// threads.  Every thread returns once all of dst is written.
__device__ __forceinline__ void stage(float* dst, const float* src, int count,
                                      uint64_t* bar) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int bulk = aligned ? (count & ~3) : 0;
  const uint32_t bar_s = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  if (bulk > 0 && threadIdx.x == 0) {
    const uint32_t dst_s =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const uint32_t bytes = static_cast<uint32_t>(bulk) * 4u;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_s)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     bar_s),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(dst_s),
        "l"(src), "r"(bytes), "r"(bar_s)
        : "memory");
  }
  for (int i = bulk + threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  __syncthreads();  // the barrier is initialised and the tail written
  if (bulk > 0) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{ .reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p; }"
          : "=r"(done)
          : "r"(bar_s)
          : "memory");
    }
  }
}

template <int G, int MODE, bool UNIT, bool SQUARE>
__global__ void __launch_bounds__(kColThreads, kColCtasPerSm)
spmv_cols_kernel(const int64_t* __restrict__ blockptr,
                 const int32_t* __restrict__ idx,
                 const float* __restrict__ val,
                 const float* __restrict__ x,
                 float* __restrict__ partial,
                 int64_t n_out, int64_t n_in, int n_rb, int n_ranges) {
  constexpr int kSegs = 32 / G;  // column sub-ranges a warp sums at a time
  extern __shared__ __align__(128) float x_s[];
  __shared__ __align__(8) uint64_t staged;
  const int t = blockIdx.x / n_ranges;
  const int range = blockIdx.x % n_ranges;
  const int row0 = t * kRowBlock;
  if constexpr (MODE == kFull) {
    const int64_t left = n_in - row0;
    stage(x_s, x + row0, static_cast<int>(left < kRowBlock ? left : kRowBlock),
          &staged);
  }
  const int lane = threadIdx.x & 31;
  const int g = lane / G;  // this lane's sub-range within the warp's group
  const int l = lane % G;  // its place among the sub-range's G lanes
  const int64_t stride = static_cast<int64_t>(n_rb) + 1;
  // The range's columns are range, range + n_ranges, ...; the warp takes
  // kSegs consecutive ones of them at a time.
  const int64_t jstep = static_cast<int64_t>(n_ranges) * kColWarps * kSegs;
  int64_t j0 = range + static_cast<int64_t>(n_ranges) * kSegs *
                           (threadIdx.x / 32);
  // Lanes 2s and 2s + 1 hold bp[j, t] and bp[j, t + 1] of the group's
  // sub-range s (column j = j0 + s * n_ranges).
  auto bounds = [&](int64_t first) -> int64_t {
    const int64_t col = first + static_cast<int64_t>(lane / 2) * n_ranges;
    return (lane < 2 * kSegs && col < n_out)
               ? blockptr[col * stride + t + (lane & 1)]
               : 0;
  };
  int64_t bnd = bounds(j0);
  for (; j0 < n_out; j0 += jstep) {  // warp-uniform
    const int64_t start = __shfl_sync(kAll, bnd, 2 * g);
    const int64_t stop = __shfl_sync(kAll, bnd, 2 * g + 1);
    bnd = bounds(j0 + jstep);  // the next group's, in flight meanwhile
    const int64_t j = j0 + static_cast<int64_t>(g) * n_ranges;
    const bool live = j < n_out;
    float acc = lane_sum<G, kColUnroll, MODE, UNIT, SQUARE>(
        idx, val, x, n_in, start + l, live ? stop : start,
        [&](int32_t c) { return x_s[c - row0]; });
#pragma unroll
    for (int offset = G / 2; offset > 0; offset >>= 1) {
      acc += __shfl_down_sync(kAll, acc, offset, G);
    }
    if (l == 0 && live) partial[static_cast<int64_t>(t) * n_out + j] = acc;
  }
}

// y[j] = partial[0, j] + ... + partial[n_rb - 1, j], in t order.
__global__ void __launch_bounds__(256)
spmv_combine_kernel(const float* __restrict__ partial, float* __restrict__ y,
                    int64_t n_out, int n_rb) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (j >= n_out) return;
  float acc = 0.0f;
  for (int t = 0; t < n_rb; ++t) acc += partial[t * n_out + j];
  y[j] = acc;
}

// CTAs of `kernel` the card holds at once (SMs x resident CTAs an SM).
template <class Kernel>
cudaError_t resident_ctas(Kernel kernel, int threads, int smem,
                          int64_t* ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(kernel), threads, smem);
  }
  *ctas = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <int G, int MODE, bool UNIT, bool SQUARE>
cudaError_t launch_rows(const int64_t* indptr, const int32_t* idx,
                        const float* val, const float* x, float* y,
                        int64_t n_out, int64_t n_in, cudaStream_t stream) {
  auto kernel = spmv_rows_kernel<G, MODE, UNIT, SQUARE>;
  int64_t persistent = 0;
  cudaError_t err = resident_ctas(kernel, kRowThreads, 0, &persistent);
  if (err != cudaSuccess) return err;
  constexpr int64_t kRowsPerCta = kRowWarps * (32 / G);
  const int64_t needed = (n_out + kRowsPerCta - 1) / kRowsPerCta;
  const int64_t blocks = needed < persistent ? needed : persistent;
  kernel<<<static_cast<unsigned>(blocks), kRowThreads, 0, stream>>>(
      indptr, idx, val, x, y, n_out, n_in);
  return cudaGetLastError();
}

template <int G, int MODE, bool UNIT, bool SQUARE>
photon::SharedMemoryOptIn& cols_opt_in() {
  static photon::SharedMemoryOptIn opt_in;
  return opt_in;
}

// Shared memory and column ranges of one column-kernel launch.
template <int G, int MODE, bool UNIT, bool SQUARE>
cudaError_t cols_grid(int64_t n_out, int64_t n_in, int n_rb, int* smem,
                      int* n_ranges) {
  auto kernel = spmv_cols_kernel<G, MODE, UNIT, SQUARE>;
  const int64_t rows = n_in < kRowBlock ? n_in : kRowBlock;
  *smem = MODE == kFull ? static_cast<int>((rows + 3) / 4 * 16) : 0;
  cudaError_t err = cols_opt_in<G, MODE, UNIT, SQUARE>().ensure(
      reinterpret_cast<const void*>(kernel), *smem);
  if (err != cudaSuccess) return err;
  int64_t ctas = 0;
  err = resident_ctas(kernel, kColThreads, *smem, &ctas);
  if (err != cudaSuccess) return err;
  // One wave: each row block gets ctas / n_rb ranges, and no range has
  // fewer columns than the CTA has warps.
  int64_t ranges = ctas / n_rb;
  const int64_t most = (n_out + kColWarps - 1) / kColWarps;
  if (ranges > most) ranges = most;
  *n_ranges = static_cast<int>(ranges > 0 ? ranges : 1);
  return cudaSuccess;
}

template <int G, int MODE, bool UNIT, bool SQUARE>
cudaError_t launch_cols(const int64_t* blockptr, const int32_t* idx,
                        const float* val, const float* x, float* partial,
                        float* y, int64_t n_out, int64_t n_in, int n_rb,
                        cudaStream_t stream) {
  int smem = 0, n_ranges = 0;
  cudaError_t err =
      cols_grid<G, MODE, UNIT, SQUARE>(n_out, n_in, n_rb, &smem, &n_ranges);
  if (err != cudaSuccess) return err;
  float* out = n_rb == 1 ? y : partial;
  spmv_cols_kernel<G, MODE, UNIT, SQUARE>
      <<<static_cast<unsigned>(n_rb) * n_ranges, kColThreads, smem,
         stream>>>(blockptr, idx, val, x, out, n_out, n_in, n_rb, n_ranges);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_rb == 1) return err;
  spmv_combine_kernel<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0,
                        stream>>>(partial, y, n_out, n_rb);
  return cudaGetLastError();
}

template <int MODE, bool UNIT, bool SQUARE>
struct Instance {
  static constexpr int kMode = MODE;
  static constexpr bool kUnit = UNIT;
  static constexpr bool kSquare = SQUARE;
};

// Calls f(Instance<...>{}) for the instance (mode, unit, square) names: the
// three FULL instances, and the valued, unsquared ablation modes.
template <class F>
cudaError_t by_instance(int mode, int unit, int square, F&& f) {
  if (mode == kFull && unit) return f(Instance<kFull, true, false>{});
  if (mode == kFull && square) return f(Instance<kFull, false, true>{});
  if (mode == kFull) return f(Instance<kFull, false, false>{});
  if (unit || square) return cudaErrorInvalidValue;
  if (mode == kNoGather) return f(Instance<kNoGather, false, false>{});
  if (mode == kStream) return f(Instance<kStream, false, false>{});
  return cudaErrorInvalidValue;
}

// Calls f(std::integral_constant<int, G>{}) for G = group.
template <class F>
cudaError_t by_group(int group, F&& f) {
  switch (group) {
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The rows in one block of the column side (the library's R), and the
// column kernel's loads in flight per lane.
int photon_spmv_row_block() { return kRowBlock; }
int photon_spmv_col_unroll() { return kColUnroll; }

// The column ranges a production (FULL, valued) column launch with `group`
// lanes a sub-range uses for an n_out x n_in problem on the current device,
// or -1 when a query fails.
int photon_spmv_col_ranges(int group, long long n_out, long long n_in) {
  const int n_rb = static_cast<int>((n_in + kRowBlock - 1) / kRowBlock);
  int smem = 0, n_ranges = 0;
  const cudaError_t err = by_group(group, [&](auto g) {
    return cols_grid<decltype(g)::value, kFull, false, false>(
        n_out, n_in, n_rb > 0 ? n_rb : 1, &smem, &n_ranges);
  });
  return err == cudaSuccess ? n_ranges : -1;
}

// The row side: y (n_out) from indptr (n_out + 1), idx/val, x (n_in), with
// `group` lanes a row (4, 8, 16 or 32).  mode 0 is FULL (unit and square
// pick the production instance); modes 1 NOGATHER and 2 STREAM take only the
// valued, unsquared layout.  n_out must be positive.  Returns 0 on a
// clean launch, else the cudaError_t code (cudaErrorInvalidValue, unlaunched,
// for an unknown mode or group).
int photon_spmv_rows(int mode, int group, int unit, int square,
                     const void* indptr, const void* idx, const void* val,
                     const void* x, void* y, long long n_out, long long n_in,
                     void* stream) {
  return static_cast<int>(by_instance(mode, unit, square, [&](auto inst) {
    using I = decltype(inst);
    return by_group(group, [&](auto g) {
      return launch_rows<decltype(g)::value, I::kMode, I::kUnit, I::kSquare>(
          static_cast<const int64_t*>(indptr),
          static_cast<const int32_t*>(idx), static_cast<const float*>(val),
          static_cast<const float*>(x), static_cast<float*>(y), n_out, n_in,
          static_cast<cudaStream_t>(stream));
    });
  }));
}

// The column side: y (n_out) from blockptr (n_out x (n_rb + 1)), idx/val and
// x (n_in), where n_rb = ceil(n_in / photon_spmv_row_block()), with `group`
// lanes a column sub-range.  partial (n_rb x n_out floats) is scratch,
// unused when n_rb is 1.  Modes as for photon_spmv_rows.  n_out and n_rb
// must be positive.
int photon_spmv_cols(int mode, int group, int unit, int square,
                     const void* blockptr, const void* idx, const void* val,
                     const void* x, void* partial, void* y, long long n_out,
                     long long n_in, int n_rb, void* stream) {
  return static_cast<int>(by_instance(mode, unit, square, [&](auto inst) {
    using I = decltype(inst);
    return by_group(group, [&](auto g) {
      return launch_cols<decltype(g)::value, I::kMode, I::kUnit, I::kSquare>(
          static_cast<const int64_t*>(blockptr),
          static_cast<const int32_t*>(idx), static_cast<const float*>(val),
          static_cast<const float*>(x), static_cast<float*>(partial),
          static_cast<float*>(y), n_out, n_in, n_rb,
          static_cast<cudaStream_t>(stream));
    });
  }));
}

}  // extern "C"
