// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every source exposes plain C entry points (no PyTorch headers) that the
// Python wrappers load with ctypes. Each entry launches on the stream it is
// given, allocates nothing and returns cudaGetLastError() after its launches,
// so a refused launch (too many threads, too much shared memory) reaches the
// wrapper, which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with the Python wrappers (kernels/bcq_mm.py::DTYPE_CODES)
enum DTypeCode : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Smallest batch-row tile in {1, 2, 4, 8} that covers min(B, 8) rows.
inline int row_tile(int B) {
  if (B >= 5) return 8;
  if (B >= 3) return 4;
  if (B >= 2) return 2;
  return 1;
}

}  // namespace repro

#define REPRO_EXPORT_ERROR_STRING                                \
  extern "C" const char* repro_cuda_error_string(int code) {     \
    return cudaGetErrorString(static_cast<cudaError_t>(code));   \
  }
