// Per-device state of the kernels' launchers, read or set once a device
// instead of on every launch: the device's SM count, and each kernel's
// permission to take up to kMaxSmem of dynamic shared memory.
// cudaFuncSetAttribute and cudaDeviceGetAttribute cost host time that a
// small kernel does not hide; cudaGetDevice, which names the device, still
// runs on every launch.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory a block can use
constexpr int kMaxDevices = 64;

// The current device, which indexes the per-device state below.
inline int current_device(int* dev) {
  const cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  return *dev < kMaxDevices ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Lets `kernel` take up to kMaxSmem of dynamic shared memory on device
// `dev`, once a device (`done` is the kernel's own flags).
template <typename Kernel>
int allow_max_smem(Kernel kernel, int dev, std::atomic<bool> (&done)[kMaxDevices]) {
  if (done[dev].load(std::memory_order_acquire)) return 0;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(kMaxSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  done[dev].store(true, std::memory_order_release);
  return 0;
}

// The SM count of device `dev`, read at its first call.
inline int sm_count(int dev, int* sms) {
  static std::atomic<int> known[kMaxDevices];
  *sms = known[dev].load(std::memory_order_acquire);
  if (*sms > 0) return 0;
  const cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  known[dev].store(*sms, std::memory_order_release);
  return 0;
}
