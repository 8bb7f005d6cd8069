// K4n · u8 NHWC image batch -> normalised f32, one pass.
//
// Replaces: coin_tpu/data/augment.py `normalize_batch` (:123)
// ((x / 255 - CLIP mean) / CLIP std, fused by XLA on the TPU); the GDINO and
// GLIP teachers normalise with ImageNet's constants the same way
// (coin_tpu/models/gdino_detector.py:230).
//
// Bound: bytes. At the shipped eval shape (4, 608, 1216, 3) it reads 8.9 MB
// and writes 35.5 MB, about 13 us at 3.35 TB/s.
// Design: the function has 256 inputs per channel. Each block first fills a
// 3 x 256 f32 table in shared memory, each entry from the same three
// correctly rounded IEEE operations as the plain version (x / 255, minus the
// mean, over the std: PyTorch divides tensor by tensor, correctly rounded on
// the card, data/augment._div), behind one barrier. Every output is then a
// table read, bit for bit the plain version's, with no division in the
// stream. Each warp moves one step of 512 bytes: a lane loads four 4-byte
// words 32 words apart and stores each word's four floats as one 16-byte
// streaming store, so every load and store of the warp is contiguous. The
// grid covers the input once (a block per 4096 bytes). Since 4 = 1 (mod 3),
// the first channel of word k is k % 3, a 32-bit modulo a word. The last
// n % 4 bytes take a scalar tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kWordsPerBlock = 4 * kThreads;   // 128 per warp

struct Norm {
  float mean[3];
  float std[3];
};

__global__ void __launch_bounds__(kThreads)
normalize_kernel(const uint8_t* __restrict__ in, float* __restrict__ out,
                 long long n, Norm p) {
  __shared__ float table[3 * 256];
  for (int e = threadIdx.x; e < 3 * 256; e += kThreads) {
    const int c = e >> 8;
    table[e] = __fdiv_rn(__fsub_rn(__fdiv_rn((float)(e & 255), 255.0f),
                                   p.mean[c]),
                         p.std[c]);
  }
  __syncthreads();

  // a warp takes 128 consecutive 4-byte words, word base + 32 m + lane
  // for m = 0..3: four coalesced 4-byte loads and four coalesced 16-byte
  // stores
  const unsigned words = (unsigned)(n / 4);
  const unsigned* in4 = reinterpret_cast<const unsigned*>(in);
  float4* out4 = reinterpret_cast<float4*>(out);
  const unsigned lane = threadIdx.x & 31;
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  const unsigned base = (t >> 5) * 128;
  unsigned v[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const unsigned k = base + 32 * m + lane;
    v[m] = k < words ? __ldcs(in4 + k) : 0u;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const unsigned k = base + 32 * m + lane;
    if (k < words) {
      // the channels of word k's bytes: c, c + 1, c + 2, c (mod 3)
      const unsigned c = k % 3;
      const float* a = table + 256 * c;
      const float* b = table + 256 * (c == 2 ? 0 : c + 1);
      const float* d = table + 256 * (c == 0 ? 2 : c - 1);
      __stcs(out4 + k, make_float4(a[v[m] & 255u], b[(v[m] >> 8) & 255u],
                                   d[(v[m] >> 16) & 255u], a[v[m] >> 24]));
    }
  }
  const long long i = 4LL * words + t;
  if (i < n) out[i] = table[256 * (int)(i % 3) + in[i]];
}

}  // namespace

// in: n bytes of an NHWC u8 tensor with 3 channels, 16-byte aligned, n <
// 2^33; out: n float32 values, 16-byte aligned. Returns the CUDA error code
// of the launch (0 on success).
extern "C" int coin_normalize(const void* in, void* out, long long n,
                              float m0, float m1, float m2, float s0,
                              float s1, float s2, void* stream) {
  if (n <= 0 || n / 4 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Norm p = {{m0, m1, m2}, {s0, s1, s2}};
  const unsigned words = (unsigned)(n / 4);
  // a block per 1024 words; block 0 also takes the tail (n < 4: no words)
  const unsigned blocks = words == 0 ? 1 : (words - 1) / kWordsPerBlock + 1;
  normalize_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (float*)out, n, p);
  return (int)cudaGetLastError();
}
