// Mat-vec over the v2 window layout — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel experiments/exp_g8192_v2.py::make_matvec (its
// pl.pallas_call over matvec_kernel).  The layout, built on the host by
// photon_ml_tpu_torch/experiments/g8192_v2.py::build_layout, packs each
// 8192-row block b into slots (b, a, l): lane l = row % 128, sublane
// a = window * 64 + depth, where window = column // 128.  Each slot holds
// lo = column % 128, v = the value and rhi = (row % 8192) // 128; padded
// slots hold lo = 0, v = 0, rhi = 0, exactly as the reference's do.
//
// What it computes, for every block b, row group h in [0, 64), lane l:
//
//     out[b, h, l] = sum over a with rhi[b, a, l] == h of
//                    v[b, a, l] * w[(a / 64) * 128 + lo[b, a, l]]
//
// so out[b, h, l] is the margin of row b * 8192 + h * 128 + l.  lo must lie
// in [0, 128) and rhi in [0, 64) (build_layout's guarantee).
//
// Every slot is summed, padded ones included, as the reference sums them:
// a padded slot adds 0 * w[window * 128] to row group 0, so an inf or NaN
// there turns out[b, 0, l] into NaN, in the kernel as in the reference.
// Skipping padded slots (or stopping a cell at its first zero v) would give
// another result for such a w, and would read fewer bytes than the bound
// below counts.
//
// Bound on this card: bytes.  The three slot arrays are read once:
// 3 x 4 B x 128 x 4096 x 128 = 805 MB at 2^20 rows, 0.2417 ms at 3.35 TB/s,
// about three times the 0.0814 ms that the live entries alone would need
// (the layout fills about half its slots, and each carries rhi as well).
//
// Design.  For a fixed block b, the sublanes [a0, a0 + S) of each array are
// one contiguous run of S x 512 bytes, so one bulk asynchronous copy
// (cp.async.bulk) moves a whole tile of S sublanes x 128 lanes.
//
// - A ring of P stages in shared memory, each holding the lo, v and rhi
//   tiles of S sublanes (3 x S x 512 B).  One producer thread (its own warp)
//   keeps P stages in flight: it waits on the stage's "empty" mbarrier,
//   arms its "full" mbarrier with the stage's bytes, and starts three bulk
//   copies (photon::Ring in common.cuh).  So P x 3 x S x 512 B are in
//   flight per SM whatever the consumer warps do.
// - One owner thread per (accumulator copy c, lane l).  out[b, h, l] depends
//   only on lane l, so thread (c, l) keeps acc[c][h][l] (h = 0..63) in shared
//   memory without races: it gathers w[window * 128 + lo] from w staged in
//   shared memory and adds v * w into acc[c][rhi][l].  With index
//   h * 128 + l the banks are l mod 32: no conflicts.  Copy c takes the
//   sublanes s = c, c + C, c + 2C, ... of each tile, in order.
// - After a block's last tile the C copies are added in the order
//   0, 1, ..., C-1 and written to out[b]; the copies are zeroed for the next
//   block while the producer already streams its tiles.
// - A persistent grid: min(n_blocks, the CTAs the card holds), each CTA
//   walking blocks blockIdx.x, blockIdx.x + gridDim.x, ...  At 2^20 rows
//   that is one CTA per block (128 CTAs on 132 SMs), a single wave.
//
// Shared memory: P x 3 x S x 512 B (ring) + 32 KB (w) + C x 32 KB (acc) <=
// 227 KB.  S, P and C are constants of the library (PHOTON_WINDOW_TILE,
// _STAGES, _COPIES), chosen by measurement with
// photon_ml_tpu_torch/experiments/window_ring.py, which also builds the
// read-only pass (PHOTON_WINDOW_STREAM_ONLY: the same ring and grid, no
// arithmetic) that gives the stream's ceiling.
//
// No atomics: every copy sums its slots in a fixed order and the copies are
// added in a fixed order, so two runs are bitwise equal.
//
// Interface: plain C functions called through ctypes.  The launch runs on
// the caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().  lo, v and rhi must be 16-byte aligned (bulk copies);
// a misaligned one is refused with cudaErrorMisalignedAddress.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

#ifndef PHOTON_WINDOW_TILE
#define PHOTON_WINDOW_TILE 16
#endif
#ifndef PHOTON_WINDOW_STAGES
#define PHOTON_WINDOW_STAGES 4
#endif
#ifndef PHOTON_WINDOW_COPIES
#define PHOTON_WINDOW_COPIES 2
#endif
#ifndef PHOTON_WINDOW_STREAM_ONLY
#define PHOTON_WINDOW_STREAM_ONLY 0
#endif

namespace {

constexpr int kWindows = 64;                    // W: column windows of 128
constexpr int kDepth = 64;                      // DEPTH: slots per cell
constexpr int kSublanes = kWindows * kDepth;    // A = 4096
constexpr int kLanes = 128;
constexpr int kDim = kWindows * kLanes;         // D = 8192: w, and one acc copy

constexpr int kTile = PHOTON_WINDOW_TILE;       // S: sublanes a stage
constexpr int kStages = PHOTON_WINDOW_STAGES;   // P
constexpr int kCopies = PHOTON_WINDOW_COPIES;   // C: accumulator copies
constexpr bool kStreamOnly = PHOTON_WINDOW_STREAM_ONLY != 0;

constexpr int kTiles = kSublanes / kTile;       // tiles a block
constexpr int kTileFloats = kTile * kLanes;
constexpr uint32_t kTileBytes = kTileFloats * sizeof(float);
constexpr int kStageFloats = 3 * kTileFloats;   // lo, v, rhi
constexpr int kRingFloats = kStages * kStageFloats;
constexpr int kConsumers = kCopies * kLanes;    // owner threads
constexpr int kThreads = kConsumers + 32;       // + the producer warp
constexpr int kSharedBytes =
    (kRingFloats + kDim + kCopies * kDim) * static_cast<int>(sizeof(float));

static_assert(kDepth % kTile == 0, "a tile must lie in one column window");
static_assert(kTile % kCopies == 0, "each copy takes S / C sublanes a tile");
static_assert(kTileBytes % 16 == 0, "bulk copies move 16-byte units");
static_assert(kSharedBytes + sizeof(photon::Ring<kStages>) <= 227 * 1024,
              "ring + w + accumulators exceed 227 KB of shared memory");

// Named barrier 1 over the consumer threads only (the producer never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
window_matvec_kernel(const int32_t* __restrict__ lo,
                     const float* __restrict__ v,
                     const int32_t* __restrict__ rhi,
                     const float* __restrict__ w,
                     float* __restrict__ out,
                     int64_t n_blocks) {
  extern __shared__ __align__(128) float smem[];
  __shared__ photon::Ring<kStages> ring;
  float* ring_s = smem;                 // (kStages, 3, kTile, kLanes)
  float* w_s = smem + kRingFloats;      // (kDim,)
  float* acc = w_s + kDim;              // (kCopies, kWindows, kLanes)

  if (threadIdx.x == 0) ring.init(kConsumers / 32);
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one thread copies
    if (threadIdx.x != kConsumers) return;
    photon::RingCursor cur;
    for (int64_t b = blockIdx.x; b < n_blocks; b += gridDim.x) {
      const int64_t block = b * kSublanes * kLanes;
      for (int t = 0; t < kTiles; ++t) {
        photon::ring_produce(ring, cur, 3 * kTileBytes);
        float* dst = ring_s + cur.stage * kStageFloats;
        uint64_t* full = &ring.full[cur.stage];
        const int64_t at = block + static_cast<int64_t>(t) * kTileFloats;
        photon::bulk_copy_to_shared(dst, lo + at, kTileBytes, full);
        photon::bulk_copy_to_shared(dst + kTileFloats, v + at, kTileBytes,
                                    full);
        photon::bulk_copy_to_shared(dst + 2 * kTileFloats, rhi + at,
                                    kTileBytes, full);
        cur.advance<kStages>();
      }
    }
    return;
  }

  // Consumer thread (c, l): the owner of acc[c][*][l].
  const int l = threadIdx.x % kLanes;
  const int c = threadIdx.x / kLanes;
  for (int i = threadIdx.x; i < kDim; i += kConsumers) w_s[i] = w[i];
  float* mine = acc + c * kDim + l;
  for (int h = 0; h < kWindows; ++h) mine[h * kLanes] = 0.0f;
  consumers_sync();  // w_s is whole

  photon::RingCursor cur;
  for (int64_t b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    for (int t = 0; t < kTiles; ++t) {
      photon::ring_consume(ring, cur);
      if constexpr (!kStreamOnly) {
        const float* stage = ring_s + cur.stage * kStageFloats;
        const int32_t* lo_t = reinterpret_cast<const int32_t*>(stage);
        const float* v_t = stage + kTileFloats;
        const int32_t* rhi_t =
            reinterpret_cast<const int32_t*>(stage + 2 * kTileFloats);
        const float* w_win = w_s + (t * kTile / kDepth) * kLanes;
#pragma unroll
        for (int j = 0; j < kTile / kCopies; ++j) {
          const int i = (j * kCopies + c) * kLanes + l;
          mine[rhi_t[i] * kLanes] += v_t[i] * w_win[lo_t[i]];
        }
      }
      photon::ring_release(ring, cur);
      cur.advance<kStages>();
    }

    consumers_sync();  // every copy holds block b's sums
    float* out_b = out + b * kDim;
    for (int o = threadIdx.x; o < kDim; o += kConsumers) {
      float sum = acc[o];
#pragma unroll
      for (int k = 1; k < kCopies; ++k) sum += acc[k * kDim + o];
      out_b[o] = sum;
    }
    consumers_sync();  // every copy has been read
    for (int h = 0; h < kWindows; ++h) mine[h * kLanes] = 0.0f;
  }
}

photon::SharedMemoryOptIn g_opt_in;

// The CTAs of one launch over n_blocks blocks: at most one per block, at
// most as many as the card holds at once.
cudaError_t grid_size(long long n_blocks, int* ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = g_opt_in.ensure(
      reinterpret_cast<const void*>(window_matvec_kernel), kSharedBytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(window_matvec_kernel),
        kThreads, kSharedBytes);
  }
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *ctas = static_cast<int>(n_blocks < resident ? n_blocks : resident);
  return err;
}

}  // namespace

extern "C" {

// The library's design constants and the grid of a launch over n_blocks
// blocks, into out[0..6): S (sublanes a tile), P (stages), C (accumulator
// copies), threads a CTA, dynamic shared memory bytes, CTAs; and whether
// this is the read-only build, into out[6].  Returns a cudaError_t code.
int photon_window_config(long long n_blocks, int* out) {
  int ctas = 0;
  const cudaError_t err = grid_size(n_blocks, &ctas);
  out[0] = kTile;
  out[1] = kStages;
  out[2] = kCopies;
  out[3] = kThreads;
  out[4] = kSharedBytes;
  out[5] = ctas;
  out[6] = kStreamOnly ? 1 : 0;
  return static_cast<int>(err);
}

// Returns 0 on a clean launch, else the cudaError_t code.  lo, v and rhi are
// (n_blocks, 4096, 128) and 16-byte aligned, w is (8192,), out is
// (n_blocks, 64, 128); n_blocks must be positive.
int photon_window_matvec(const void* lo, const void* v, const void* rhi,
                         const void* w, void* out, long long n_blocks,
                         void* stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(lo) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(rhi);
  if (bases & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  int ctas = 0;
  const cudaError_t err = grid_size(n_blocks, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_matvec_kernel<<<ctas, kThreads, kSharedBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lo), static_cast<const float*>(v),
      static_cast<const int32_t*>(rhi), static_cast<const float*>(w),
      static_cast<float*>(out), n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
