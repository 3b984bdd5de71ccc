// Per-device shared-memory grants, for the sources whose kernels may take
// more than 48 KB of dynamic shared memory a block and keep what they were
// granted (rttg_latency.cu, ssd_scan.cu).
//
// Above 48 KB a block's dynamic shared memory must be opted into with
// cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
// bytes), which applies to the calling thread's current device alone.  A
// Grants holds one kernel's grant on each device ordinal (cudaGetDevice), so
// a launch on a card that no earlier call opted in opts in there.  A grant
// only grows, under the Grants' mutex: host threads launching on one card
// never shrink each other's.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

constexpr int DEFAULT_SMEM_BYTES = 48 * 1024;

struct Grants {
  std::mutex mutex;
  std::vector<int> bytes;  // by device ordinal, sized by cudaGetDeviceCount at first use
};

// Opt `kernel` into `smem` bytes of dynamic shared memory on the current
// device, unless an earlier call granted as much there.  Returns the CUDA
// error code.
static cudaError_t grant_on_device(const void* kernel, Grants& grants, int smem) {
  if (smem <= DEFAULT_SMEM_BYTES) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(grants.mutex);
  if (grants.bytes.empty()) {
    int count = 0;
    err = cudaGetDeviceCount(&count);
    if (err != cudaSuccess) return err;
    grants.bytes.assign(count, DEFAULT_SMEM_BYTES);
  }
  if (device < 0 || device >= (int)grants.bytes.size()) return cudaErrorInvalidDevice;
  if (smem <= grants.bytes[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) grants.bytes[device] = smem;
  return err;
}
