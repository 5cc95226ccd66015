// Helpers shared by the port's kernels: io-dtype conversion, relu6, and the
// C-interface conventions (each entry makes the tensors' device current for
// its launch, launches on the caller's stream and returns cudaGetLastError()).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rn {

enum Dtype : int { kF32 = 0, kBF16 = 1 };

// An entry's error code at or above kCuResult is a CUresult (libcuda's
// status, e.g. a tensor map cuTensorMapEncodeTiled refused) plus kCuResult;
// below it, a cudaError_t.
constexpr int kCuResult = 100000;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
// Round to nearest even, like torch's .to(torch.bfloat16).
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A float rounded to the io dtype and back (an intermediate held in T).
template <typename T> __device__ __forceinline__ float round_io(float v) {
  return to_f32(from_f32<T>(v));
}

// NaN stays NaN, as in the plain versions (torch.maximum/minimum) and JAX's
// jnp.clip; fminf/fmaxf alone would turn it into 0.
__device__ __forceinline__ float relu6(float v) { return v != v ? v : fminf(fmaxf(v, 0.f), 6.f); }

// x*w + b with no fused multiply-add, as the plain PyTorch version rounds it.
__device__ __forceinline__ float affine(float x, float w, float b) {
  return __fadd_rn(__fmul_rn(x, w), b);
}

// Makes `device` current for the life of one C entry and then restores the
// caller's device, so a launch on cuda:1 leaves PyTorch's current device as
// it found it. The entry's `return cudaGetLastError()` runs before the
// destructor.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  bool restore_ = false;
  cudaError_t err_;
};

// 16-byte asynchronous copy from global to shared memory (cp.async, L2
// only). With `valid` false nothing is read and the 16 bytes are zeroed;
// `gmem` must still be a mapped address.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 32;  // grid-stride beyond 32 blocks per SM
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace rn

extern "C" const char* rn_error_string(int code) {
  if (code >= rn::kCuResult) return "a libcuda call failed (the code less 100000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
