// Shared by every kernel library of mmfn_tpu_torch: each .cu file is built
// into its own shared library with a plain C interface (loaded with ctypes),
// so each one exports its own error-string helper.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* mmfn_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
