// Kernel-engine canary: out = x + 1 on one [8, 128] f32 tile.
//
// Replaces the TPU canary `k` (tdmpc2_tpu/ops/pallas_rollout.py, run by
// mosaic_engine_alive), which proves that the chip's kernel engine can
// compile and run a program at all. Here it proves that nvcc's output for
// sm_90a loads and launches on the card and computes. One block of 1024
// threads, one element each: 8 KB moved, launch-bound by construction.
#include <cuda_runtime.h>

namespace {

__global__ void probe_kernel(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 1.f;
}

}  // namespace

extern "C" const char* tdm_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

// Launch on `stream`; returns cudaGetLastError() after the launch.
extern "C" int tdm_probe(const float* x, float* out, int n, void* stream) {
  const int threads = 1024;
  probe_kernel<<<(n + threads - 1) / threads, threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}
