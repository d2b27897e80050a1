// Shared by every kernel library of the port (each .cu is built alone into
// its own shared library, so each library gets one copy of these).
#pragma once

#include <cuda_runtime.h>

namespace photon {

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
