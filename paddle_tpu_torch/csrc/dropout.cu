// Dropout for Hopper (sm_90a): one pass that reads x, draws each
// element's keep decision from a counter-based hash of (op seed, element
// index), and writes Out and the uint8 Mask.
//
// The op seed is a 63-bit int64 that lives on the device (the executor's
// step seed folded with the op index, core/rng.py), read here through a
// pointer, so a captured CUDA graph draws a new mask at every replay from
// the seed written before it. The hash is core/rng.py `keep_hash`:
//
//   h = fmix32((uint32(i) * 0x9E3779B1) ^ seed_lo);  h = fmix32(h ^ seed_hi)
//
// with murmur3's finalizer fmix32, and an element is kept where
// h >= thresh (thresh = min(p * 2^32, 2^32 - 1)). Kept elements are
// x * scale in float32, rounded to x's type (scale = float32(1 / (1 - p))
// for upscale_in_train, as PyTorch divides by a scalar on the card), and
// dropped ones are 0; with `upscale` 0 kept elements pass unchanged.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond this

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);
template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <>
__device__ __forceinline__ float load_f32<__half>(const __half* p) {
  return __half2float(*p);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                   uint8_t* __restrict__ mask, long long n,
                   const long long* __restrict__ seed, uint32_t thresh,
                   float scale, bool upscale) {
  const unsigned long long s = static_cast<unsigned long long>(__ldg(seed));
  const uint32_t lo = static_cast<uint32_t>(s);
  const uint32_t hi = static_cast<uint32_t>(s >> 32);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint32_t h =
        fmix32(fmix32((static_cast<uint32_t>(i) * 0x9E3779B1u) ^ lo) ^ hi);
    const bool keep = h >= thresh;
    const T xv = x[i];
    T o;
    if (!keep)
      o = from_f32<T>(0.f);
    else if (upscale)
      o = from_f32<T>(load_f32<T>(&xv) * scale);
    else
      o = xv;
    out[i] = o;
    if (mask != nullptr) mask[i] = keep ? 1 : 0;
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, void* mask, long long n,
                   const long long* seed, uint32_t thresh, float scale,
                   int upscale, cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dropout_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<uint8_t*>(mask), n, seed, thresh, scale, upscale != 0);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. x and out hold n contiguous
// elements, mask n bytes (or null: Out only); seed points at one int64 on
// the device. Returns the cudaError_t of the launch (0 = launched).
extern "C" int dropout_forward(int dtype, const void* x, void* out,
                               void* mask, long long n,
                               const long long* seed, uint32_t thresh,
                               float scale, int upscale, void* stream) {
  if (n < 0 || dtype < 0 || dtype > 2 || seed == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, out, mask, n, seed, thresh, scale,
                                upscale, st);
    case 1:
      return (int)launch<__nv_bfloat16>(x, out, mask, n, seed, thresh, scale,
                                        upscale, st);
    default:
      return (int)launch<__half>(x, out, mask, n, seed, thresh, scale,
                                 upscale, st);
  }
}
