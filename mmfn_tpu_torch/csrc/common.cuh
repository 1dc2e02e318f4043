// Shared by every kernel library of mmfn_tpu_torch: each .cu file is built
// into its own shared library with a plain C interface (loaded with ctypes),
// so each one exports its own error-string helper.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

extern "C" const char* mmfn_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One attribute of one kernel, set once per device and process rather than
// on every launch. Each kernel instance owns one static KernelAttribute per
// attribute it needs.
class KernelAttribute {
  public:
    cudaError_t ensure(const void* kernel, cudaFuncAttribute attr, int value) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
        std::call_once(once_[dev], [&] { err_[dev] = cudaFuncSetAttribute(kernel, attr, value); });
        return err_[dev];
    }

  private:
    static constexpr int kMaxDevices = 64;
    std::once_flag once_[kMaxDevices];
    cudaError_t err_[kMaxDevices] = {};
};
