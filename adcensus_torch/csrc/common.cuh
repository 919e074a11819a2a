// Shared by every kernel library of adcensus_torch: the export macro, the
// sentinels of adcensus_torch/config.py, and an error-string entry point.
//
// Each .cu file builds into its own shared library with a plain C
// interface (no PyTorch headers), loaded by adcensus_torch/ops/_build.py
// with ctypes. Every entry point launches on the stream it is given and
// returns cudaGetLastError(); the Python wrapper raises on a nonzero code.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ADC_EXPORT extern "C" __attribute__((visibility("default")))

// adcensus_types.h:35 (Large_Float)
#define ADC_LARGE_FLOAT 99999.0f

ADC_EXPORT const char* adc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

static inline unsigned int adc_blocks(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}
