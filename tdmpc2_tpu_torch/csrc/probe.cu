// Kernel-engine canary: out = x + 1 on a contiguous f32 tensor of any size.
//
// Replaces the TPU canary `k` (tdmpc2_tpu/ops/pallas_rollout.py:233, run by
// mosaic_engine_alive), which proves that the chip's kernel engine can
// compile and run a program at all. Here it proves that nvcc's output for
// sm_90a loads and launches on the card and computes. Its work is bytes (4
// read and 4 written an element: the [8, 128] tile the canary runs is 8 KB,
// 2.4 ns at 3.35 TB/s), so what the card spends on it is the launch and one
// round trip to memory; the kernel keeps the instructions and memory
// transactions of that round trip few. Each thread moves one float4: one
// 16-byte load and one 16-byte store, 128 threads a block, over a grid that
// covers any n. A scalar head up to x's first 16-byte boundary and a scalar
// tail (n % 4) take the rest, so a view with a storage offset runs too; where
// out is not aligned as x is, the float4 loads stay and the stores are split.
// Aligned x and out with n a multiple of 4 (the canary's tile) take a kernel
// of the float4 body alone, measured faster there than the general kernel
// (PERF.md §6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* x, float* out, long n, int head, long nvec, bool vec_out) {
  const long i = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < nvec) {
    float4 v = reinterpret_cast<const float4*>(x + head)[i];
    v.x += 1.f;
    v.y += 1.f;
    v.z += 1.f;
    v.w += 1.f;
    float* o = out + head + 4 * i;
    if (vec_out) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      o[0] = v.x;
      o[1] = v.y;
      o[2] = v.z;
      o[3] = v.w;
    }
  }
  if (i < head) out[i] = x[i] + 1.f;
  const long tail = head + 4 * nvec;
  if (i < n - tail) out[tail + i] = x[tail + i] + 1.f;
}

// The common case, x and out 16-byte aligned and n a multiple of 4 below
// 2^31: the float4 body alone, on 32-bit indices.
__global__ void __launch_bounds__(kThreads)
probe_vec4_kernel(const float4* x, float4* out, int nvec) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < nvec) {
    float4 v = x[i];
    v.x += 1.f;
    v.y += 1.f;
    v.z += 1.f;
    v.w += 1.f;
    out[i] = v;
  }
}

}  // namespace

extern "C" const char* tdm_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

// x, out: n floats each (4-byte aligned, as every f32 tensor is). Launch on
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int tdm_probe(const float* x, float* out, long n, void* stream) {
  const long to16 = ((16 - reinterpret_cast<uintptr_t>(x) % 16) % 16) / 4;
  const int h = static_cast<int>(to16 < n ? to16 : n);
  const long nvec = (n - h) / 4;
  const bool vec_out = reinterpret_cast<uintptr_t>(out + h) % 16 == 0;
  const long threads = nvec > 3 ? nvec : 3;   // the head and the tail have at most 3
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h == 0 && vec_out && n % 4 == 0 && n < (1L << 31)) {
    probe_vec4_kernel<<<blocks, kThreads, 0, st>>>(reinterpret_cast<const float4*>(x),
                                                   reinterpret_cast<float4*>(out),
                                                   static_cast<int>(nvec));
  } else {
    probe_kernel<<<blocks, kThreads, 0, st>>>(x, out, n, h, nvec, vec_out);
  }
  return static_cast<int>(cudaGetLastError());
}
