// K5b · int8 RoIAlign backward for Hopper: the straight-through gradient of
// the features; the RoIs get none.
//
// Replaces: coin_tpu/ops/roi_align.py `_ra_int8_bwd` (:213-232), the exact
// bilinear transpose that the JAX package runs as two dense einsums on the
// TPU: with ax, ay (the unquantised interpolation matrices, rounded to the
// features' dtype) and the incoming gradient g in the features' dtype,
//   t[n, h, s, c] = dtype(sum_r ay[n, r, h] g[n, r, s, c])   (f32 sums)
//   df[h, w, c]   = dtype(sum_{n, s} t[n, h, s, c] ax[n, s, w])   (f32)
// The rounding of t to the features' dtype is what sets this apart from
// K1b (csrc/roi_align_bwd.cu), which rounds once at the output and
// contracts x first.
//
// Bound: bytes. At the training shapes (3 images x 576 rois, 14 x 14, 1024
// channels, bf16) the kernel must read the 693.6 MB gradient and write the
// 17.7 MB feature gradient once: about 0.21 ms at 3.35 TB/s.
//
// Design: K1b's, in the JAX op's order. The first version ran a block per
// (RoI, feature row h), 3 x 576 x 38 blocks of which most exited at once;
// each block that stayed re-read from device memory every output row that
// touches h, so the gradient was read about as many times as a cell has
// taps along y, and it sent one 16-byte atomic per output column's tap.
// Here a block owns one RoI and 256 channels (64 above resolution 16):
// 1. 2R threads give each cell of each axis its distinct taps with their
//    weights, the mean of its samples' tents summed in sample order and
//    rounded to the dtype (csrc/roi_taps.cuh, as K1 and K1b take them; the
//    same weights as the first version's build_cell: the header's tents
//    1 - (p - lo) and 1 - ((lo + 1) - p) are 1 - |p - g| at g = lo, lo + 1);
//    a weight that rounds to 0 is no tap;
// 2. the footprint along each axis is the set of map rows (columns) that
//    some tap reaches, numbered in ascending order through a bitmap of the
//    map, so rows and columns that no sample reaches cost nothing and no
//    RoI needs more than 2 R s of either, whatever its size; beside each,
//    the range of cells that reach it;
// 3. the block walks its channels 32 at a time (8 above resolution 16):
//    the R x R tile of the next chunk streams into shared memory
//    (cp.async, two buffers) while the block works on the current one, so
//    each RoI's gradient is read from device memory once;
// 4. per band of 8 footprint rows y: T[y][s] = sum_r ay[r][y] G[r][s] over
//    the cells r that reach y, ascending, in f32, rounded to the dtype, into
//    shared memory; then D[y][x] = sum_s T[y][s] ax[s][x] over the cells s
//    that reach x, in f32, in registers;
// 5. each D[y][x] goes into the f32 (B, H, W, C) buffer with one 16-byte
//    vector atomic per 4 channels: one per footprint pixel, where the
//    first version sent one per cell and tap.
// Channel counts off the 16-byte copies take a path of single-element
// copies and atomics. The caller casts the buffer to the features' dtype;
// atomics from RoIs that overlap add in no fixed order, so results vary in
// the last bits from run to run, and a t near a rounding boundary may round
// to the neighbouring value: the kernel is held to its plain version at a
// stated tolerance.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "roi_taps.cuh"

#if defined(__CUDACC_VER_MAJOR__) &&                                     \
    (__CUDACC_VER_MAJOR__ > 12 ||                                        \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 5))
#define COIN_VECTOR_ATOMICS 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSampling = 4;
constexpr int kMaxRes = 32;
constexpr int kMaxTaps = 2 * kMaxSampling;   // distinct taps of a cell
constexpr int kBand = 8;                     // footprint rows of a band
constexpr int kChunks = 8;                   // channel chunks of a block

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One cell's distinct taps along an axis and their weights: the mean of its
// samples' tents, summed in sample order, rounded to T; zero weights
// dropped.
struct Cell {
  int n;
  int idx[kMaxTaps];
  float w[kMaxTaps];
};

template <typename T>
__device__ void build_cell(float start, float bin, int r, int S, int size,
                           Cell& cell) {
  int n = 0;
  float sum[kMaxTaps];
  int idx[kMaxTaps] = {};
  auto add = [&](int g, float w) {
    int i = 0;
    while (i < n && idx[i] != g) ++i;
    if (i == n) {
      idx[n] = g;
      sum[n] = 0.0f;
      ++n;
    }
    sum[i] = __fadd_rn(sum[i], w);
  };
  for (int k = 0; k < S; ++k) {
    const roi_taps::Tap t = roi_taps::sample_tap(start, bin, r, k, S, size);
    if (!t.in) continue;
    add(t.lo, t.wlo);
    if (t.hi != t.lo) add(t.hi, t.whi);
  }
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const float w = round_to<T>(__fdiv_rn(sum[i], (float)S));
    if (w == 0.0f) continue;
    cell.idx[m] = idx[i];
    cell.w[m] = w;
    ++m;
  }
  cell.n = m;
}

// the footprint's number of map index g: the set bits below it
__device__ __forceinline__ int rank(const uint32_t* bits, const int* before,
                                    int g) {
  return before[g >> 5] + __popc(bits[g >> 5] & ((1u << (g & 31)) - 1u));
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& g) {
  acc.x = fmaf(w, g.x, acc.x);
  acc.y = fmaf(w, g.y, acc.y);
  acc.z = fmaf(w, g.z, acc.z);
  acc.w = fmaf(w, g.w, acc.w);
}

// dst[0:valid] += v; a 16-byte vector atomic when all four are there
__device__ __forceinline__ void flush4(float* dst, const float4& v, int valid,
                                      bool vec) {
#ifdef COIN_VECTOR_ATOMICS
  if (vec) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
    return;
  }
#endif
  const float a[4] = {v.x, v.y, v.z, v.w};
  for (int j = 0; j < valid; ++j) atomicAdd(dst + j, a[j]);
}

__device__ __forceinline__ float4 to_f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 to_f4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of channels [c0, c0 + CS) of the RoI's R x R cells into
// Gs ([cell][CS] of T); channels past C are zeros. VEC: 16-byte copies
// that land while the block works on the previous chunk.
template <typename T, int CS, bool VEC>
__device__ __forceinline__ void load_chunk(const T* g, int cells, int C,
                                           int c0, T* Gs) {
  constexpr int P = 16 / sizeof(T);  // values of a 16-byte piece
  constexpr int pieces = CS / P;
  for (int idx = threadIdx.x; idx < cells * pieces; idx += kThreads) {
    const int cell = idx / pieces, c = (idx - cell * pieces) * P;
    T* dst = Gs + cell * CS + c;
    const T* src = g + (long long)cell * C + c0 + c;
    if (VEC && c0 + c + P <= C) {
      cp_async16(dst, src);
    } else {
      for (int j = 0; j < P; ++j)
        dst[j] = c0 + c + j < C ? src[j] : T(0.0f);
    }
  }
  cp_async_commit();
}

// The footprint of one axis in shared memory.
struct Axis {
  float* w;          // [footprint][R]: the weight of cell r at that index
  int* lo;           // [footprint]: the first and last cell that reach it
  int* hi;
  int* id;           // [footprint]: its map index
  uint32_t* bits;    // [(size + 31) / 32]: the map indices reached
  int* before;       // [(size + 31) / 32]: set bits in the words before
  int words;
};

template <typename T, int CS, bool VEC>
__global__ void __launch_bounds__(kThreads)
roi_align_int8_bwd_kernel(const T* __restrict__ grad,
                          const float* __restrict__ rois,
                          float* __restrict__ dfeat, int H, int W, int C,
                          int rois_per_image, float spatial_scale, int R,
                          int S, int ny_max, int nx_max) {
  constexpr int Q = CS / 4;                  // float4 per cell of a chunk
  constexpr int LQ = Q == 8 ? 3 : 1;         // log2(Q)
  static_assert(Q == 1 << LQ, "a chunk is 8 or 32 channels");
  extern __shared__ float4 smem4[];
  float4* Ts = smem4;                        // [R][kBand][Q]
  T* Gs = reinterpret_cast<T*>(Ts + kBand * R * Q);   // 2 x [R * R][CS]
  float* fl = reinterpret_cast<float*>(Gs + 2 * R * R * CS);
  Axis ay, ax;
  ay.w = fl;
  ax.w = ay.w + ny_max * R;
  int* in = reinterpret_cast<int*>(ax.w + nx_max * R);
  ay.lo = in; ay.hi = ay.lo + ny_max; ay.id = ay.hi + ny_max;
  ax.lo = ay.id + ny_max; ax.hi = ax.lo + nx_max; ax.id = ax.hi + nx_max;
  ay.words = (H + 31) / 32;
  ax.words = (W + 31) / 32;
  ay.bits = reinterpret_cast<uint32_t*>(ax.id + nx_max);
  ax.bits = ay.bits + ay.words;
  ay.before = reinterpret_cast<int*>(ax.bits + ax.words);
  ax.before = ay.before + ay.words;
  __shared__ int count[2];                   // footprint rows, columns

  const int t = threadIdx.x;
  const long long roi = blockIdx.x;
  const int first = blockIdx.y * kChunks * CS;
  const int chunks = min(kChunks, (C - first + CS - 1) / CS);
  const int b = (int)(roi / rois_per_image);
  const T* g = grad + roi * R * R * C;
  load_chunk<T, CS, VEC>(g, R * R, C, first, Gs);

  // 1. the taps of cell t (y) or t - R (x), kept in registers
  const roi_taps::Frame f =
      roi_taps::frame(rois + 4 * roi, spatial_scale, R);
  const bool is_y = t < R, is_x = t >= R && t < 2 * R;
  const int r = is_y ? t : t - R;
  Axis& a = is_y ? ay : ax;
  Cell cell;
  cell.n = 0;
  if (is_y) build_cell<T>(f.y1, f.bin_h, r, S, H, cell);
  if (is_x) build_cell<T>(f.x1, f.bin_w, r, S, W, cell);
  for (int i = t; i < ay.words + ax.words; i += kThreads) ay.bits[i] = 0u;
  __syncthreads();
  // 2. the footprints: the map indices reached, then their numbers
  for (int i = 0; i < cell.n; ++i) {
    atomicOr(a.bits + (cell.idx[i] >> 5), 1u << (cell.idx[i] & 31));
  }
  __syncthreads();
  if (t == 0 || t == 32) {
    Axis& s = t == 0 ? ay : ax;
    int n = 0;
    for (int w = 0; w < s.words; ++w) {
      s.before[w] = n;
      n += __popc(s.bits[w]);
    }
    count[t == 0 ? 0 : 1] = n;
  }
  __syncthreads();
  const int ny = count[0], nx = count[1];
  if (ny == 0 || nx == 0) {
    cp_async_wait<0>();
    return;                                  // every sample off the map
  }
  for (int i = t; i < ny * R; i += kThreads) ay.w[i] = 0.0f;
  for (int i = t; i < nx * R; i += kThreads) ax.w[i] = 0.0f;
  for (int i = t; i < ny; i += kThreads) { ay.lo[i] = R; ay.hi[i] = -1; }
  for (int i = t; i < nx; i += kThreads) { ax.lo[i] = R; ax.hi[i] = -1; }
  __syncthreads();
  for (int i = 0; i < cell.n; ++i) {
    const int j = rank(a.bits, a.before, cell.idx[i]);
    a.w[j * R + r] = cell.w[i];
    a.id[j] = cell.idx[i];
    atomicMin(a.lo + j, r);
    atomicMax(a.hi + j, r);
  }

  // bands of 2**lb footprint rows: the least power of two that holds the
  // footprint's rows, at most kBand
  const int lb = 32 - __clz(min(ny, kBand) - 1);
  float* base = dfeat + (long long)b * H * W * C;
  for (int ci = 0; ci < chunks; ++ci) {
    const int c0 = first + ci * CS;
    const T* G = Gs + (ci & 1) * R * R * CS;
    if (ci + 1 < chunks) {
      load_chunk<T, CS, VEC>(g, R * R, C, c0 + CS,
                             Gs + ((ci + 1) & 1) * R * R * CS);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int yc = 0; yc < ny; yc += 1 << lb) {
      // along y: T[s][yl] over the cells r that reach row yc + yl, rounded
      // (the index runs over q, then yl, then s: shifts, no division)
      for (int idx = t; idx < (R << lb) << LQ; idx += kThreads) {
        const int q = idx & (Q - 1), yl = (idx >> LQ) & ((1 << lb) - 1);
        const int s = idx >> (lb + LQ), y = yc + yl;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (y < ny) {
          for (int rr = ay.lo[y]; rr <= ay.hi[y]; ++rr)
            fma4(acc, ay.w[y * R + rr], to_f4(G + (rr * R + s) * CS + 4 * q));
        }
        Ts[idx] = make_float4(round_to<T>(acc.x), round_to<T>(acc.y),
                              round_to<T>(acc.z), round_to<T>(acc.w));
      }
      __syncthreads();
      // along x, then the flush: one vector atomic per pixel and 4 channels
      for (int idx = t; idx < (nx << lb) << LQ; idx += kThreads) {
        const int q = idx & (Q - 1), yl = (idx >> LQ) & ((1 << lb) - 1);
        const int x = idx >> (lb + LQ), y = yc + yl, c = c0 + 4 * q;
        if (y >= ny || c >= C) continue;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int s = ax.lo[x]; s <= ax.hi[x]; ++s)
          fma4(acc, ax.w[x * R + s], Ts[(((s << lb) + yl) << LQ) + q]);
        const int valid = min(4, C - c);
        flush4(base + ((long long)ay.id[y] * W + ax.id[x]) * C + c, acc,
               valid, VEC && valid == 4);
      }
      __syncthreads();
    }
  }
}

// the footprint's bound along one axis: at most two taps a sample
int footprint_max(int size, int R, int S) {
  return size < 2 * R * S ? size : 2 * R * S;
}

template <typename T, int CS>
size_t smem_bytes(int H, int W, int R, int S) {
  const size_t ny = footprint_max(H, R, S), nx = footprint_max(W, R, S);
  return sizeof(float) * kBand * (size_t)R * CS +
         sizeof(T) * 2 * (size_t)R * R * CS +
         sizeof(float) * (ny + nx) * R + sizeof(int) * 3 * (ny + nx) +
         sizeof(int) * 2 * (size_t)((H + 31) / 32 + (W + 31) / 32);
}

template <typename T, int CS, bool VEC>
int launch(const void* grad, const void* rois, void* dfeat, int H, int W,
           int C, int total_rois, int rois_per_image, float spatial_scale,
           int res, int sampling, cudaStream_t s) {
  auto kernel = roi_align_int8_bwd_kernel<T, CS, VEC>;
  const size_t smem = smem_bytes<T, CS>(H, W, res, sampling);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)total_rois,
            (unsigned)((C + kChunks * CS - 1) / (kChunks * CS)));
  kernel<<<grid, kThreads, smem, s>>>(
      (const T*)grad, (const float*)rois, (float*)dfeat, H, W, C,
      rois_per_image, spatial_scale, res, sampling,
      footprint_max(H, res, sampling), footprint_max(W, res, sampling));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* grad, const void* rois, void* dfeat, int H,
                 int W, int C, int total_rois, int rois_per_image,
                 float spatial_scale, int res, int sampling, cudaStream_t s) {
  // 16-byte copies of the gradient need C a multiple of 8 (bf16) or 4
  // (f32); the vector atomics need C a multiple of 4
  const bool vec = C % (16 / (int)sizeof(T)) == 0 &&
                   (((uintptr_t)grad | (uintptr_t)dfeat) % 16) == 0;
  auto run = res <= 16 ? (vec ? &launch<T, 32, true> : &launch<T, 32, false>)
                       : (vec ? &launch<T, 8, true> : &launch<T, 8, false>);
  return run(grad, rois, dfeat, H, W, C, total_rois, rois_per_image,
             spatial_scale, res, sampling, s);
}

}  // namespace

// grad (total_rois, res, res, C) in the features' dtype (0 = float32, 1 =
// bfloat16); rois (total_rois, 4) float32, image b owning rows
// [b * rois_per_image, (b + 1) * rois_per_image); dfeat (B, H, W, C)
// float32, zeroed by the caller. res <= 32, sampling <= 4. Returns the CUDA
// error code of the launch.
extern "C" int coin_roi_align_int8_bwd(const void* grad, const void* rois,
                                       void* dfeat, int H, int W, int C,
                                       int total_rois, int rois_per_image,
                                       float spatial_scale, int res,
                                       int sampling, int dtype,
                                       void* stream) {
  if (res <= 0 || res > kMaxRes || sampling < 1 || sampling > kMaxSampling ||
      total_rois <= 0 || H <= 0 || W <= 0 || C <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch_dtype<float>(grad, rois, dfeat, H, W, C, total_rois,
                               rois_per_image, spatial_scale, res, sampling,
                               s);
  }
  if (dtype == 1) {
    return launch_dtype<__nv_bfloat16>(grad, rois, dfeat, H, W, C,
                                       total_rois, rois_per_image,
                                       spatial_scale, res, sampling, s);
  }
  return (int)cudaErrorInvalidValue;
}
