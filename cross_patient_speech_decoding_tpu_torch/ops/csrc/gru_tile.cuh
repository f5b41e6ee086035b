// The gate nonlinearity of the GRU kernels (gru_fwd.cu, gru_bwd.cu), in
// float32.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

}  // namespace
