// K4n · u8 NHWC image batch -> CLIP-normalised f32, one pass.
//
// Replaces: coin_tpu/data/augment.py `normalize_batch`
// ((x / 255 - CLIP mean) / CLIP std, fused by XLA on the TPU).
//
// Bound: bytes. At the shipped eval shape (4, 608, 1216, 3) it reads 8.9 MB
// and writes 35.5 MB, about 13 us at 3.35 TB/s, and does 3 flops per byte
// read. Design: each thread takes 4 consecutive bytes (one 32-bit load)
// and writes 4 floats (one 128-bit store); the channel of element i is
// i % 3. A scalar tail handles sizes that are not a multiple of 4. The
// arithmetic is the same three correctly rounded IEEE operations, in the
// same order, as XLA's and the plain version's; PyTorch may turn a division
// by a scalar into a product with its reciprocal, so the two agree to a
// few ulp, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Norm {
  float mean[3];
  float std[3];
};

__device__ __forceinline__ float norm1(uint8_t v, int c, const Norm& p) {
  return __fdiv_rn(__fsub_rn(__fdiv_rn((float)v, 255.0f), p.mean[c]),
                   p.std[c]);
}

__global__ void __launch_bounds__(kThreads)
normalize_kernel(const uint8_t* __restrict__ in, float* __restrict__ out,
                 long long n, Norm p) {
  const long long n4 = n / 4;
  const uchar4* in4 = reinterpret_cast<const uchar4*>(in);
  float4* out4 = reinterpret_cast<float4*>(out);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < n4; q += stride) {
    const uchar4 v = in4[q];
    const int c = (int)((q * 4) % 3);
    float4 o;
    o.x = norm1(v.x, c, p);
    o.y = norm1(v.y, (c + 1) % 3, p);
    o.z = norm1(v.z, (c + 2) % 3, p);
    o.w = norm1(v.w, c, p);
    out4[q] = o;
  }
  for (long long i = n4 * 4 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = norm1(in[i], (int)(i % 3), p);
  }
}

}  // namespace

// in: n bytes of an NHWC u8 tensor with 3 channels; out: n float32 values.
// Both pointers must be 16-byte aligned. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int coin_normalize(const void* in, void* out, long long n,
                              const float* mean, const float* std,
                              void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Norm p;
  for (int c = 0; c < 3; ++c) {
    p.mean[c] = mean[c];
    p.std[c] = std[c];
  }
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;
  normalize_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (float*)out, n, p);
  return (int)cudaGetLastError();
}
