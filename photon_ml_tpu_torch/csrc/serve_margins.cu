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
// cold is the zero row, so their sum is exact), on the fused or composed
// argument layout, or on where the request side lives (HBM or page-locked
// host memory).  A library reduction (torch.sum, a GEMV) picks its blocking
// and split from the number of output rows, so its summation order changes
// with the bucket.  Here the order depends only on each coordinate's width:
// one warp a row, lane l sums the columns d = l, l+32, l+64, ... in
// increasing d, then a fixed xor-shuffle tree (16, 8, 4, 2, 1) adds the 32
// lane sums, and each coordinate's sum is formed before it is added to the
// total, the coordinates in order.  Every add and multiply is an explicit
// round-to-nearest intrinsic, so nvcc contracts nothing into an FMA, and
// serving/kernels.py's plain version (the same order in torch ops) gives
// the same bits.
//
// Bound on this card: latency.  A 64-row bucket of a 512 + 8 wide model
// moves ~140 KB (a few hundred ns at 3.35 TB/s); what a row waits for is
// the launch and memory round trips.  So the schedule keeps a row to two
// round trips: the first carries every random coordinate's hot slot, the
// row's offset and the first fixed coordinate's features and means; the
// second the first kRegRandom random coordinates' features, hot-table rows
// and cold rows (they need the slot).  Only then do the adds start.  A
// lane holds KF columns of a fixed coordinate in registers (the template
// parameter: the widest fixed coordinate's columns a lane, rounded up to a
// power of two, at most kMaxColumns = 16, 512 columns), loaded at constant
// offsets from one row pointer, and one column of each of those random
// coordinates up to 32 wide.  Columns and coordinates beyond those are
// read in loops in the same order, so any model runs; each costs a round
// trip of its own.  At one warp a row the kernel is bound by instruction
// issue as much as by round trips (PERF.md §6): a flat register list of
// every coordinate's columns was slower, and so were more register slots
// for random coordinates (PHOTON_SERVE_RANDOM_REGS = 8 against 2 cost
// 0.0002-0.0003 ms a launch on both served models, which have one).
//
// Where the inputs live: the serving runtime passes its page-locked staging
// buffers (request rows, slots, the (2, n) output) by the address the card
// reads them at under unified addressing, so a bucket is one launch with no
// copy either way; the model side (fixed means, hot tables) stays in HBM.
// photon_serve_mapped is the check that an address is such memory.
//
// Warps a block: one row a warp, PHOTON_SERVE_WARPS = 8 warps a block
// (fewer for a smaller bucket).  Measured on an H100 80GB HBM3 at 700 W
// with photon_ml_tpu_torch/experiments/serve_launch.py --sweep
// PHOTON_SERVE_WARPS=1,2,4,8: at bucket 1 every choice is one warp; at
// bucket 64 with the request side in HBM all four lie within 0.0062-0.0066
// ms, and reading it from page-locked host memory (the runtime's
// placement) 1, 2, 4 and 8 warps took 0.0187, 0.0161, 0.0149 and 0.0142
// ms on the 512 + 8 model and 0.0140, 0.0119, 0.0109 and 0.0103 ms on the
// 64 + 8 one: fewer, fuller blocks read host memory faster.

// Interface: plain C functions called through ctypes.  photon_serve_launch
// takes a prebuilt Coords block (serving/kernels.py mirrors it as a
// ctypes.Structure, checked against photon_serve_coords_layout at load);
// photon_serve_margins builds one from per-coordinate arrays.  A launch
// runs on the caller's stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError().  Slots must lie in [0, rows of the table)
// (the runtime's LRU guarantees it; checking on the card would need a
// read-back).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

#ifndef PHOTON_SERVE_WARPS
#define PHOTON_SERVE_WARPS 8
#endif
#ifndef PHOTON_SERVE_RANDOM_REGS
#define PHOTON_SERVE_RANDOM_REGS 2
#endif

namespace {

constexpr int kMaxFixed = 8;
constexpr int kMaxRandom = 8;
constexpr int kWarpsPerBlock = PHOTON_SERVE_WARPS;
constexpr int kWarp = 32;
constexpr int kMaxColumns = 16;
constexpr int kRegRandom = PHOTON_SERVE_RANDOM_REGS;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kMaxRandom <= kWarp, "one lane reads each random slot");

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
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
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

// Columns a lane holds of a coordinate `dim` wide.
__host__ __device__ __forceinline__ int lane_columns(int dim) {
  return (dim + kWarp - 1) / kWarp;
}

// Round trip 2's loads of fixed coordinate i: lane l's columns l + 32k,
// k < KF, at constant offsets from one row pointer.
template <int KF>
__device__ __forceinline__ void load_fixed(const Coords& c, int i,
                                           long long row, int lane,
                                           float (&x)[KF], float (&w)[KF]) {
  const float* xr = c.fx[i] + row * c.fx_stride[i] + lane;
  const float* wr = c.fw[i] + lane;
  const int dim = c.fd[i];
#pragma unroll
  for (int k = 0; k < KF; ++k) {
    x[k] = w[k] = 0.0f;
    if (lane + kWarp * k < dim) {
      x[k] = xr[kWarp * k];
      w[k] = wr[kWarp * k];
    }
  }
}

// Random coordinate j's lane sum read column by column, for one wider
// than 32 or past the register slots: x · (hot + cold), in column order.
__device__ __forceinline__ float random_lane_sum(const Coords& c, int j,
                                                 long long row, int lane,
                                                 int my_slot) {
  const int dim = c.rd[j];
  const int slot = __shfl_sync(kFull, my_slot, j);
  const float* x = c.rx[j] + row * c.rx_stride[j];
  const float* hot = c.rtable[j] + static_cast<long long>(slot) * dim;
  const float* cold = c.rcold[j] + row * c.rcold_stride[j];
  float acc = 0.0f;
  for (int d = lane; d < dim; d += kWarp) {
    acc = __fadd_rn(acc, __fmul_rn(x[d], __fadd_rn(hot[d], cold[d])));
  }
  return acc;
}

template <int KF>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
serve_margins_kernel(const Coords c) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row = static_cast<long long>(blockIdx.x) *
                            (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (row >= c.n) return;  // whole warps leave together

  // Round trip 1: lane j reads random coordinate j's slot; the offset; and
  // the first fixed coordinate's columns, which need no slot.
  int my_slot = 0;
  if (lane < c.n_random) my_slot = c.rslot[lane][row];
  const float offset = c.offset[row * c.offset_stride];
  float xf[KF], wf[KF];
  if (c.n_fixed > 0) load_fixed<KF>(c, 0, row, lane, xf, wf);

  // Round trip 2: each of the first kRegRandom random coordinates up to 32
  // wide (one column a lane): its features, hot-table row and cold row.
  float rx[kRegRandom], rh[kRegRandom], rc[kRegRandom];
#pragma unroll
  for (int j = 0; j < kRegRandom; ++j) {
    rx[j] = rh[j] = rc[j] = 0.0f;
    if (j < c.n_random && c.rd[j] <= kWarp) {
      const int slot = __shfl_sync(kFull, my_slot, j);
      if (lane < c.rd[j]) {
        rx[j] = c.rx[j][row * c.rx_stride[j] + lane];
        rh[j] = c.rtable[j][static_cast<long long>(slot) * c.rd[j] + lane];
        rc[j] = c.rcold[j][row * c.rcold_stride[j] + lane];
      }
    }
  }

  // The adds, in the plain version's order: fixed coordinates, then
  // random ones, each coordinate's lane sums from zero in increasing
  // column, then the xor tree.  A coordinate wider than the register tier
  // (KF columns a lane, or 32 columns for a random one) takes the rest of
  // its columns in a loop, in the same order.
  float total = offset;
  for (int i = 0; i < c.n_fixed; ++i) {
    if (i > 0) load_fixed<KF>(c, i, row, lane, xf, wf);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < KF; ++k) {
      if (lane + kWarp * k < c.fd[i]) {
        acc = __fadd_rn(acc, __fmul_rn(xf[k], wf[k]));
      }
    }
    const float* x = c.fx[i] + row * c.fx_stride[i];
    for (int d = lane + kWarp * KF; d < c.fd[i]; d += kWarp) {
      acc = __fadd_rn(acc, __fmul_rn(x[d], c.fw[i][d]));
    }
    total = __fadd_rn(total, warp_sum(acc));
  }
#pragma unroll
  for (int j = 0; j < kRegRandom; ++j) {
    if (j < c.n_random) {
      const int dim = c.rd[j];
      float acc = 0.0f;
      if (dim > kWarp) {
        acc = random_lane_sum(c, j, row, lane, my_slot);
      } else if (lane < dim) {
        acc = __fadd_rn(acc, __fmul_rn(rx[j], __fadd_rn(rh[j], rc[j])));
      }
      total = __fadd_rn(total, warp_sum(acc));
    }
  }
  for (int j = kRegRandom; j < c.n_random; ++j) {
    total = __fadd_rn(total,
                      warp_sum(random_lane_sum(c, j, row, lane, my_slot)));
  }
  if (lane == 0) {
    c.out[row] = total;
    c.out[c.n + row] = mean_link(total, c.link);
  }
}

__global__ void empty_kernel() {}

int launch_coords(const Coords& c, cudaStream_t stream) {
  if (c.n_fixed < 0 || c.n_fixed > kMaxFixed || c.n_random < 0 ||
      c.n_random > kMaxRandom || c.n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (c.n == 0) return 0;
  // The register tier: the most columns a lane holds of any fixed
  // coordinate, rounded up to a power of two, at most kMaxColumns.
  int cols = 1;
  for (int i = 0; i < c.n_fixed; ++i) {
    while (cols < lane_columns(c.fd[i]) && cols < kMaxColumns) cols *= 2;
  }
  const int warps =
      c.n < kWarpsPerBlock ? static_cast<int>(c.n) : kWarpsPerBlock;
  const dim3 grid(static_cast<unsigned>((c.n + warps - 1) / warps));
  const dim3 block(warps * kWarp);
  switch (cols) {
    case 1: serve_margins_kernel<1><<<grid, block, 0, stream>>>(c); break;
    case 2: serve_margins_kernel<2><<<grid, block, 0, stream>>>(c); break;
    case 4: serve_margins_kernel<4><<<grid, block, 0, stream>>>(c); break;
    case 8: serve_margins_kernel<8><<<grid, block, 0, stream>>>(c); break;
    default:
      serve_margins_kernel<kMaxColumns><<<grid, block, 0, stream>>>(c);
  }
  return static_cast<int>(cudaGetLastError());
}

// Runs ``fn`` with ``device`` current, then restores the caller's device.
template <typename F>
int on_device(int device, F fn) {
  int prev = -1;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (prev != device && (e = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  const int rc = fn();
  if (prev != device) cudaSetDevice(prev);
  return rc;
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
      n_random > kMaxRandom) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return launch_coords(c, static_cast<cudaStream_t>(stream));
}

// One launch from a prebuilt block (a Coords) on ``device``'s ``stream``.
int photon_serve_launch(const void* block, int device, void* stream) {
  return on_device(device, [&] {
    return launch_coords(*static_cast<const Coords*>(block),
                         static_cast<cudaStream_t>(stream));
  });
}

// The Coords layout for the ctypes mirror's check: out[0] = sizeof, then
// the offsets of offset, n, out, fx, fd, rx, rslot, rd.  Returns the count
// written.
int photon_serve_coords_layout(long long* out, int cap) {
  const long long vals[] = {
      static_cast<long long>(sizeof(Coords)),
      static_cast<long long>(offsetof(Coords, offset)),
      static_cast<long long>(offsetof(Coords, n)),
      static_cast<long long>(offsetof(Coords, out)),
      static_cast<long long>(offsetof(Coords, fx)),
      static_cast<long long>(offsetof(Coords, fd)),
      static_cast<long long>(offsetof(Coords, rx)),
      static_cast<long long>(offsetof(Coords, rslot)),
      static_cast<long long>(offsetof(Coords, rd)),
  };
  const int n = static_cast<int>(sizeof(vals) / sizeof(vals[0]));
  for (int i = 0; i < n && i < cap; ++i) out[i] = vals[i];
  return n;
}

// The address at which ``device`` reads host memory ``host``: 0 and
// *device_ptr set when ``host`` lies in page-locked memory mapped for the
// card, 1 when it does not (pageable memory, or not host memory), else a
// cudaError_t code.
int photon_serve_mapped(const void* host, int device, void** device_ptr) {
  return on_device(device, [&] {
    cudaPointerAttributes attr{};
    const cudaError_t e = cudaPointerGetAttributes(&attr, host);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: this is an answer, not a fault
      return static_cast<int>(e);
    }
    if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr) {
      return 1;
    }
    *device_ptr = attr.devicePointer;
    return 0;
  });
}

// An empty kernel, one warp: the floor of a launch on this card.
int photon_serve_empty(void* stream) {
  empty_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
