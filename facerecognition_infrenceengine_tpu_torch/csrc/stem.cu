// K4: the fused SCRFD deep stem -- conv 3x3/2 (3 -> sw), conv 3x3 (sw -> sw),
// conv 3x3 (sw -> 2sw), each BN-folded + ReLU, then max-pool 3x3/2 -- in one
// kernel, from s2d4-packed uint8 camera frames, for sm_90a.
//
// Replaces the TPU kernel facerecognition_infrenceengine_tpu/ops/
// stem_pallas.py::fused_stem (body _stem_kernel).  Same function: u8 input
// preprocessed in the kernel as (x - 127.5) / 128; the convs see zero (in
// preprocessed space) outside the image and the pool sees -inf; f32
// accumulation, then + bias, ReLU and a cast of each intermediate to the
// engine dtype T (float or bf16), where the reference casts.
//
// Bound on the H100 (det_10g, sw = 28, B = 8 at 640x640): operations.
// 2.245 GMAC a frame, 35.9 GFLOP in all: 36.3 us at 989 TFLOP/s bf16
// (0.536 ms at 67 TFLOP/s f32), against ~33 MB moved (9.8 MB u8 in, 22.9 MB
// bf16 out, 9.8 us).  This first kernel runs on the FP32 cores, so it sits
// far above the bf16 bound; tensor-core (mma / wgmma) convolution is later
// work.
//
// Design.  The reference evaluates the stem in 2x2 / 4x4 phase-packed form
// to fill 128-lane vector registers, which costs 4x the MACs of conv2/3; on
// Hopper the stem is a direct convolution on the BN-folded 3x3 weights
// (HWIO, as precompute_fused_stem lays them out).  One block per (frame,
// 8x8 tile of pooled outputs) stages the tile's u8 input plus its halo
// (43x43 raw pixels, read straight from the unpadded s2d4 layout: padding
// is decided by global index, not stored), then conv1 (21x21), conv2
// (19x19) and conv3 (17x17) in shared memory, channel-major planes, two
// buffers used in turn (raw -> conv2, conv1 -> conv3); then the 3x3/2 pool
// writes the 8x8x2sw output tile, channels fastest (coalesced NHWC).  Each
// thread computes 4 output channels of one pixel; a warp shares its channel
// group, so its weight loads are one broadcast from L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;               // pooled outputs per tile side
constexpr int kRaw = 4 * kTile + 11;   // raw input rows/cols a tile reads (43)
constexpr int kC1 = 2 * kTile + 5;     // conv1 rows/cols (21)
constexpr int kC2 = 2 * kTile + 3;     // conv2 (19)
constexpr int kC3 = 2 * kTile + 1;     // conv3 (17)
constexpr int kThreads = 256;
constexpr int kG = 4;                  // output channels per thread item

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four consecutive weights (16-byte aligned for f32, 8-byte for bf16)
__device__ __forceinline__ void load4(const float* p, float w[kG]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float w[kG]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  w[0] = __uint_as_float(v.x << 16);
  w[1] = __uint_as_float(v.x & 0xffff0000u);
  w[2] = __uint_as_float(v.y << 16);
  w[3] = __uint_as_float(v.y & 0xffff0000u);
}

// One 3x3 conv over a tile held in shared memory.  in: [cin][in_w][in_w],
// out: [cout][out_w][out_w]; out pixel (oy, ox) reads in (S*oy + ky,
// S*ox + kx).  (g_row0, g_col0) is the global position of out (0, 0) in a
// (limit x limit_w) map: positions outside it are `outside` (0 = the next
// conv's zero padding, -inf = the pool's padding).
template <typename T, int S>
__device__ void conv3x3(const T* __restrict__ in, int in_w, int cin, T* __restrict__ out,
                        int out_w, int cout, const T* __restrict__ w,
                        const float* __restrict__ bias, int g_row0, int g_col0, int limit_h,
                        int limit_w, float outside) {
  const int in_plane = in_w * in_w;
  const int out_plane = out_w * out_w;
  const int items = (cout / kG) * out_plane;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int grp = item / out_plane;
    const int pix = item - grp * out_plane;
    const int oy = pix / out_w;
    const int ox = pix - oy * out_w;
    const int co0 = grp * kG;
    const int gy = g_row0 + oy;
    const int gx = g_col0 + ox;
    if (gy < 0 || gy >= limit_h || gx < 0 || gx >= limit_w) {
#pragma unroll
      for (int g = 0; g < kG; ++g) out[(co0 + g) * out_plane + pix] = from_f32<T>(outside);
      continue;
    }
    float acc[kG] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const T* ip = in + (S * oy + ky) * in_w + S * ox + kx;
        const T* wp = w + (ky * 3 + kx) * cin * cout + co0;
        for (int ci = 0; ci < cin; ++ci) {
          const float v = to_f32(ip[ci * in_plane]);
          float wv[kG];
          load4(wp + ci * cout, wv);
#pragma unroll
          for (int g = 0; g < kG; ++g) acc[g] = fmaf(v, wv[g], acc[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      out[(co0 + g) * out_plane + pix] = from_f32<T>(fmaxf(acc[g] + __ldg(bias + co0 + g), 0.0f));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_stem_kernel(const uint8_t* __restrict__ x, const T* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ w2,
                  const float* __restrict__ b2, const T* __restrict__ w3,
                  const float* __restrict__ b3, T* __restrict__ y, int h4, int w4, int sw,
                  int size_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf_a = reinterpret_cast<T*>(smem);  // raw input, then conv2
  T* buf_b = buf_a + size_a;              // conv1, then conv3
  const int i0 = blockIdx.y * kTile;      // pooled tile origin
  const int j0 = blockIdx.x * kTile;
  const int frame = blockIdx.z;
  const int h = 4 * h4, w = 4 * w4;       // raw frame
  const uint8_t* xf = x + static_cast<size_t>(frame) * h4 * w4 * 48;

  // raw tile rows/cols [4*i0 - 7, 4*i0 + 4*kTile + 4), preprocessed; zero
  // outside the frame.  s2d4: pixel (r, c) ch k sits at packed (r/4, c/4)
  // channel ((r%4)*4 + c%4)*3 + k.
  const int r0 = 4 * i0 - 7, c0 = 4 * j0 - 7;
  for (int item = threadIdx.x; item < kRaw * kRaw * 3; item += kThreads) {
    const int ry = item / (kRaw * 3);
    const int rem = item - ry * (kRaw * 3);
    const int rx = rem / 3;
    const int k = rem - rx * 3;
    const int gy = r0 + ry, gx = c0 + rx;
    float v = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const int u = xf[(static_cast<size_t>(gy >> 2) * w4 + (gx >> 2)) * 48 +
                       ((gy & 3) * 4 + (gx & 3)) * 3 + k];
      v = (static_cast<float>(u) - 127.5f) * 0.0078125f;  // exact
    }
    buf_a[(k * kRaw + ry) * kRaw + rx] = from_f32<T>(v);
  }
  __syncthreads();
  const int map_h = 2 * h4, map_w = 2 * w4;  // conv maps are H/2 x W/2
  conv3x3<T, 2>(buf_a, kRaw, 3, buf_b, kC1, sw, w1, b1, 2 * i0 - 3, 2 * j0 - 3, map_h, map_w,
                0.0f);
  __syncthreads();
  conv3x3<T, 1>(buf_b, kC1, sw, buf_a, kC2, sw, w2, b2, 2 * i0 - 2, 2 * j0 - 2, map_h, map_w,
                0.0f);
  __syncthreads();
  conv3x3<T, 1>(buf_a, kC2, sw, buf_b, kC3, 2 * sw, w3, b3, 2 * i0 - 1, 2 * j0 - 1, map_h,
                map_w, -INFINITY);
  __syncthreads();

  // 3x3/2 max-pool: pooled (py, px) reads conv3 rows/cols 2p .. 2p+2
  const int c_out = 2 * sw;
  const int plane = kC3 * kC3;
  for (int item = threadIdx.x; item < kTile * kTile * c_out; item += kThreads) {
    const int p = item / c_out;
    const int ch = item - p * c_out;
    const int py = p / kTile, px = p - (p / kTile) * kTile;
    const int gy = i0 + py, gx = j0 + px;
    if (gy >= h4 || gx >= w4) continue;
    const T* src = buf_b + ch * plane + (2 * py) * kC3 + 2 * px;
    float m = -INFINITY;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, to_f32(src[dy * kC3 + dx]));
    }
    y[((static_cast<size_t>(frame) * h4 + gy) * w4 + gx) * c_out + ch] = from_f32<T>(m);
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* w3, const void* b3, void* y, int b, int h4, int w4, int sw,
           cudaStream_t s) {
  const int raw = 3 * kRaw * kRaw, c2 = sw * kC2 * kC2;
  const int c1 = sw * kC1 * kC1, c3 = 2 * sw * kC3 * kC3;
  const int size_a = ((raw > c2 ? raw : c2) + 7) / 8 * 8;  // raw input, then conv2
  const int size_b = c1 > c3 ? c1 : c3;                    // conv1, then conv3
  const size_t bytes = static_cast<size_t>(size_a + size_b) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(fused_stem_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w4 + kTile - 1) / kTile, (h4 + kTile - 1) / kTile, b);
  fused_stem_kernel<T><<<grid, kThreads, bytes, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<const T*>(w3), static_cast<const float*>(b3), static_cast<T*>(y), h4, w4,
      sw, size_a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [b, h4, w4, 48] u8 s2d4 frames; w1 [3,3,3,sw], w2 [3,3,sw,sw],
// w3 [3,3,sw,2sw] (HWIO, BN folded) in T; b1..b3 f32; y [b, h4, w4, 2sw] in
// T; T is bf16 when is_bf16, else f32.  All contiguous; sw a multiple of 4.
extern "C" int fre_fused_stem(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* w3, const void* b3, void* y,
                              int is_bf16, int b, int h4, int w4, int sw, void* stream) {
  if (b <= 0 || h4 <= 0 || w4 <= 0) return 0;
  if (sw <= 0 || sw % kG != 0 || b > 65535 || h4 > 65535 * kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, y, b, h4, w4, sw, s);
  return launch<float>(x, w1, b1, w2, b2, w3, b3, y, b, h4, w4, sw, s);
}
