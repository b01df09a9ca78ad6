// K4: the fused SCRFD deep stem -- conv 3x3/2 (3 -> sw), conv 3x3 (sw -> sw),
// conv 3x3 (sw -> 2sw), each BN-folded + ReLU, then max-pool 3x3/2 -- in one
// kernel, from s2d4-packed uint8 camera frames, for sm_90a.
//
// Replaces the TPU kernel facerecognition_infrenceengine_tpu/ops/
// stem_pallas.py:258 fused_stem (body _stem_kernel, :185).  Same function:
// u8 input preprocessed in the kernel as (x - 127.5) / 128 (exact in bf16);
// the convs see zero (in preprocessed space) outside the image and the pool
// sees -inf; f32 accumulation, then + bias, ReLU and a cast of each
// intermediate to the engine dtype, where the reference casts.
//
// Bound on the H100 (det_10g, sw = 28, B = 8 at 640x640): operations.
// 2.245 GMAC a frame, 35.9 GFLOP in all: 36.3 us at 989 TFLOP/s bf16
// (0.536 ms at 67 TFLOP/s f32), against ~33 MB moved (9.8 MB u8 in, 22.9 MB
// bf16 out, 9.8 us).
//
// bf16 (fused_stem_mma_kernel): implicit GEMM on the tensor cores,
// mma.sync.m16n8k16 bf16 -> f32.  For each conv, M is the tile's output
// pixels, N the output channels, K the taps x input channels.  conv2 and
// conv3 read their input channels padded to CP = 16 or 32 (sw <= 16 or
// <= 32), one k-step per (tap, 16 channels).  conv1 reads raw pixels held
// with 4 channels (RGB and a zero), and one k-step per kernel row ky covers
// raw columns 2ox .. 2ox+3 (the fourth column's weights are zero): 3 k-steps
// instead of 9 taps of a channel padded to 16.  Intermediates stay in
// shared memory pixel-major, channel-fastest, so one 16-byte ldmatrix row is
// 8 channels of one pixel; a pixel's 16-byte chunks are XOR-swizzled by the
// pixel index, so the 8 rows of an ldmatrix (8 consecutive pixels) fall in 8
// different bank groups.  The BN-folded weights are staged once per block in
// shared memory in the order the MMA's B fragments read them (built on the
// host by ops/stem_kernel.pack_stem_fragments): one 8-byte load a lane per
// (k-step, 8 output channels).  The grid is persistent -- as many blocks as
// fit on the card, each walking the frames' tiles -- so a block loads the
// weights once, not once per tile (3,200 tiles at B = 8, 640x640).
//
// Tile: 8x8 pooled outputs (conv3 17x17, conv2 19x19, conv1 21x21, raw
// 43x43), chosen by occupancy.  Counting MMA work with K and N padded, the
// halo and the padding cost 1.54x the useful MACs at 8x8, 1.46x at 8x16 and
// 1.38x at 16x16 pooled outputs; but at sw = 28 those need 159 KB and 254 KB
// of shared memory (one block an SM, or none) against 107 KB at 8x8, where
// two 256-thread blocks fit an SM: 16 warps to hide the ldmatrix and MMA
// latencies, and one block's tile load overlaps the other's MMAs.  With
// bf16 products exact and f32 sums, the values differ from the plain
// version only by summation order.  What bounds this design is shared
// memory, not the tensor cores: each m16n8k16 (2,048 MACs) reads 384 bytes
// of fragments (128 B/clk an SM), which caps mma.sync near a third of the
// bf16 peak; wgmma with both operands from shared memory is the next step.
//
// f32 (fused_stem_f32_kernel) keeps the direct convolution on the FP32
// cores: TF32 would change the f32 result.  One block per (frame, 8x8 tile
// of pooled outputs) stages the tile's u8 input plus its halo (read straight
// from the unpadded s2d4 layout: padding is decided by global index, not
// stored), then conv1 (21x21), conv2 (19x19) and conv3 (17x17) in shared
// memory, channel-major planes, two buffers used in turn (raw -> conv2,
// conv1 -> conv3); then the 3x3/2 pool writes the 8x8x2sw output tile,
// channels fastest (coalesced NHWC).  Each thread computes 4 output
// channels of one pixel; a warp shares its channel group, so its weight
// loads are one broadcast from L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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

// four consecutive weights (16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float w[kG]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// One 3x3 conv over a tile held in shared memory.  in: [cin][in_w][in_w],
// out: [cout][out_w][out_w]; out pixel (oy, ox) reads in (S*oy + ky,
// S*ox + kx).  (g_row0, g_col0) is the global position of out (0, 0) in a
// (limit x limit_w) map: positions outside it are `outside` (0 = the next
// conv's zero padding, -inf = the pool's padding).
template <int S>
__device__ void conv3x3(const float* __restrict__ in, int in_w, int cin, float* __restrict__ out,
                        int out_w, int cout, const float* __restrict__ w,
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
      for (int g = 0; g < kG; ++g) out[(co0 + g) * out_plane + pix] = outside;
      continue;
    }
    float acc[kG] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* ip = in + (S * oy + ky) * in_w + S * ox + kx;
        const float* wp = w + (ky * 3 + kx) * cin * cout + co0;
        for (int ci = 0; ci < cin; ++ci) {
          const float v = ip[ci * in_plane];
          float wv[kG];
          load4(wp + ci * cout, wv);
#pragma unroll
          for (int g = 0; g < kG; ++g) acc[g] = fmaf(v, wv[g], acc[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      out[(co0 + g) * out_plane + pix] = fmaxf(acc[g] + __ldg(bias + co0 + g), 0.0f);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_stem_f32_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ w3,
                      const float* __restrict__ b3, float* __restrict__ y, int h4, int w4,
                      int sw, int size_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf_a = reinterpret_cast<float*>(smem);  // raw input, then conv2
  float* buf_b = buf_a + size_a;                  // conv1, then conv3
  const int i0 = blockIdx.y * kTile;              // pooled tile origin
  const int j0 = blockIdx.x * kTile;
  const int frame = blockIdx.z;
  const int h = 4 * h4, w = 4 * w4;               // raw frame
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
    buf_a[(k * kRaw + ry) * kRaw + rx] = v;
  }
  __syncthreads();
  const int map_h = 2 * h4, map_w = 2 * w4;  // conv maps are H/2 x W/2
  conv3x3<2>(buf_a, kRaw, 3, buf_b, kC1, sw, w1, b1, 2 * i0 - 3, 2 * j0 - 3, map_h, map_w,
             0.0f);
  __syncthreads();
  conv3x3<1>(buf_b, kC1, sw, buf_a, kC2, sw, w2, b2, 2 * i0 - 2, 2 * j0 - 2, map_h, map_w,
             0.0f);
  __syncthreads();
  conv3x3<1>(buf_a, kC2, sw, buf_b, kC3, 2 * sw, w3, b3, 2 * i0 - 1, 2 * j0 - 1, map_h,
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
    const float* src = buf_b + ch * plane + (2 * py) * kC3 + 2 * px;
    float m = -INFINITY;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, src[dy * kC3 + dx]);
    }
    y[((static_cast<size_t>(frame) * h4 + gy) * w4 + gx) * c_out + ch] = m;
  }
}

int launch_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* w3, const void* b3, void* y, int b, int h4, int w4, int sw,
               cudaStream_t s) {
  const int raw = 3 * kRaw * kRaw, c2 = sw * kC2 * kC2;
  const int c1 = sw * kC1 * kC1, c3 = 2 * sw * kC3 * kC3;
  const int size_a = ((raw > c2 ? raw : c2) + 7) / 8 * 8;  // raw input, then conv2
  const int size_b = c1 > c3 ? c1 : c3;                    // conv1, then conv3
  const size_t bytes = static_cast<size_t>(size_a + size_b) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_stem_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w4 + kTile - 1) / kTile, (h4 + kTile - 1) / kTile, b);
  fused_stem_f32_kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3), static_cast<float*>(y), h4,
      w4, sw, size_a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bf16, MMA
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kRawW = kRaw + 1;  // 44: conv1's k-steps read raw columns 2ox .. 2ox+3
constexpr int kRawPix = 4;       // bf16 channels a raw pixel holds (RGB + a zero)
constexpr int kRawBytes = kRaw * kRawW * kRawPix * 2;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned a[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Byte offset of the 16-byte chunk `chunk` (channels 8*chunk .. +7) of pixel
// q in a map of CP bf16 channels a pixel.  The chunk index is XORed with
// bits of q so that 8 consecutive pixels' same chunk lie in 8 different
// 16-byte bank groups (CP = 32: 4 chunks, 2 pixels a 128-byte bank row;
// CP = 16: 2 chunks, 4 pixels).
template <int CP>
__device__ __forceinline__ int swz(int q, int chunk) {
  constexpr int kChunks = CP / 8;
  constexpr int kShift = kChunks == 2 ? 2 : 1;
  return q * (CP * 2) + ((chunk ^ ((q >> kShift) & (kChunks - 1))) << 4);
}

// One 3x3 conv as an implicit GEMM over a tile in shared memory.  kConv1:
// A rows come from the raw tile (stride 2, one k-step per ky: raw columns
// 2ox .. 2ox+3 x 4 channels); else from a CP-channel swizzled map (stride
// 1, one k-step per (tap, 16 channels)).  Work units are (16-pixel m-tile,
// up to 4 n-tiles of 8 channels), handed to the warps in turn; the last
// m-tile's missing rows repeat its last pixel and are not stored.  Output
// pixel m sits at tile (m / out_w, m % out_w), at (g_row0, g_col0) + that
// in the H/2 x W/2 map; outside the map it is `outside` (0: the next conv's
// padding, -inf: the pool's).  kOutSwz: the output is the next conv's
// CP-channel swizzled input; else plain [pixel][n_out].
template <int CP, bool kConv1, bool kOutSwz>
__device__ __forceinline__ void conv_mma(const unsigned char* in, int in_w, unsigned char* out,
                                         int out_w, int n_tiles, int n_out,
                                         const uint2* frag, const float* bias, int g_row0,
                                         int g_col0, int map_h, int map_w, float outside) {
  constexpr int kSteps = kConv1 ? 3 : 9 * (CP / 16);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m_count = out_w * out_w;
  const int m_tiles = (m_count + 15) >> 4;
  const int n_groups = (n_tiles + 3) >> 2;
  for (int unit = warp; unit < m_tiles * n_groups; unit += kMmaWarps) {
    const int mt = unit / n_groups;
    const int nt0 = (unit - mt * n_groups) * 4;
    // this lane's ldmatrix row (pixel) and k half
    const int m = min(mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, m_count - 1);
    const int oy = m / out_w, ox = m - (m / out_w) * out_w;
    const int khalf = lane >> 4;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    }
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      unsigned a[4];
      if (kConv1) {
        ldmatrix_x4(smem_u32(in + ((2 * oy + ks) * kRawW + 2 * ox + 2 * khalf) * kRawPix * 2), a);
      } else {
        const int tap = ks / (CP / 16);
        const int ky = tap / 3, kx = tap % 3;
        const int q = (oy + ky) * in_w + ox + kx;
        ldmatrix_x4(smem_u32(in + swz<CP>(q, 2 * (ks % (CP / 16)) + khalf)), a);
      }
      const uint2* fb = frag + (ks * n_tiles + nt0) * 32 + lane;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (nt0 + j < n_tiles) mma_bf16(acc[j], a, fb[j * 32]);
      }
    }
    // C fragment: rows lane/4 and lane/4 + 8, columns 2*(lane%4) + {0, 1}
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int mm = mt * 16 + (lane >> 2) + 8 * half;
      if (mm >= m_count) continue;
      const int py = mm / out_w, px = mm - (mm / out_w) * out_w;
      const int gy = g_row0 + py, gx = g_col0 + px;
      const bool inside = gy >= 0 && gy < map_h && gx >= 0 && gx < map_w;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = nt0 + j;
        if (nt >= n_tiles) continue;
        const int c = nt * 8 + 2 * (lane & 3);
        float v0 = outside, v1 = outside;
        if (inside) {
          v0 = fmaxf(acc[j][2 * half] + bias[c], 0.0f);
          v1 = fmaxf(acc[j][2 * half + 1] + bias[c + 1], 0.0f);
        }
        const int byte = kOutSwz ? swz<CP>(mm, nt) + 4 * (lane & 3) : (mm * n_out + c) * 2;
        *reinterpret_cast<__nv_bfloat162*>(out + byte) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Persistent: block k takes tiles k, k + gridDim.x, ... of all frames.
// Shared memory: the fragment-ordered weights and padded biases (loaded
// once), then buffer A (raw tile, then conv2) and buffer B (conv1, then
// conv3).  f1 [3][CP/8][32] uint2, f2 [9*CP/16][CP/8][32], f3 [9*CP/16]
// [2sw/8][32] (ops/stem_kernel.pack_stem_fragments).
template <int CP>
__global__ void __launch_bounds__(kMmaThreads, 2)
fused_stem_mma_kernel(const uint8_t* __restrict__ x, const uint2* __restrict__ f1,
                      const float* __restrict__ b1, const uint2* __restrict__ f2,
                      const float* __restrict__ b2, const uint2* __restrict__ f3,
                      const float* __restrict__ b3, __nv_bfloat16* __restrict__ y,
                      int n_frames, int h4, int w4, int sw, int size_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kNt = CP / 8;
  constexpr int kKs = 9 * (CP / 16);
  const int n3 = sw / 4;  // conv3's n-tiles: 2sw / 8
  const int n_f1 = 3 * kNt * 32, n_f2 = kKs * kNt * 32, n_f3 = kKs * n3 * 32;
  uint2* s_f1 = reinterpret_cast<uint2*>(smem);
  uint2* s_f2 = s_f1 + n_f1;
  uint2* s_f3 = s_f2 + n_f2;
  float* s_b1 = reinterpret_cast<float*>(s_f3 + n_f3);
  float* s_b2 = s_b1 + CP;
  float* s_b3 = s_b2 + CP;  // 2 * CP entries
  unsigned char* buf_a = reinterpret_cast<unsigned char*>(s_b3 + 2 * CP);
  unsigned char* buf_b = buf_a + size_a;

  for (int i = threadIdx.x; i < (n_f1 + n_f2 + n_f3) / 2; i += kMmaThreads) {
    const uint4* src = i < n_f1 / 2 ? reinterpret_cast<const uint4*>(f1) + i
                       : i < (n_f1 + n_f2) / 2
                           ? reinterpret_cast<const uint4*>(f2) + (i - n_f1 / 2)
                           : reinterpret_cast<const uint4*>(f3) + (i - (n_f1 + n_f2) / 2);
    reinterpret_cast<uint4*>(smem)[i] = __ldg(src);
  }
  for (int c = threadIdx.x; c < 2 * CP; c += kMmaThreads) {
    if (c < CP) {
      s_b1[c] = c < sw ? __ldg(b1 + c) : 0.0f;
      s_b2[c] = c < sw ? __ldg(b2 + c) : 0.0f;
    }
    s_b3[c] = c < 2 * sw ? __ldg(b3 + c) : 0.0f;
  }

  const int tiles_x = (w4 + kTile - 1) / kTile;
  const int per_frame = tiles_x * ((h4 + kTile - 1) / kTile);
  const int total = per_frame * n_frames;
  const int map_h = 2 * h4, map_w = 2 * w4;  // conv maps are H/2 x W/2
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(buf_a);
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int frame = t / per_frame;
    const int rem = t - frame * per_frame;
    const int i0 = (rem / tiles_x) * kTile, j0 = (rem % tiles_x) * kTile;
    const uint8_t* xf = x + static_cast<size_t>(frame) * h4 * w4 * 48;

    // raw tile rows/cols [4*i0 - 7, 4*i0 + 36): zero (the padding, the
    // fourth channel, column 43), then the frame's pixels, preprocessed.
    // They come from packed rows/cols i0 - 2 .. i0 + 8 of the s2d4 frame,
    // 48 bytes a packed pixel read as three 16-byte chunks; packed channel
    // (p*4 + q)*3 + k holds raw pixel (4Y + p, 4X + q) channel k.
    for (int i = threadIdx.x; i < kRawBytes / 16; i += kMmaThreads) {
      reinterpret_cast<uint4*>(buf_a)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    for (int it = threadIdx.x; it < 11 * 11 * 3; it += kMmaThreads) {
      const int yy = it / 33, xx = (it % 33) / 3, chunk = it % 3;
      const int gy4 = i0 - 2 + yy, gx4 = j0 - 2 + xx;
      if (gy4 < 0 || gy4 >= h4 || gx4 < 0 || gx4 >= w4) continue;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                                xf + (static_cast<size_t>(gy4) * w4 + gx4) * 48) + chunk);
      const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int cc = chunk * 16 + e;
        const int pq = cc / 3, k = cc - (cc / 3) * 3;
        const int ry = 4 * yy + (pq >> 2) - 1, rx = 4 * xx + (pq & 3) - 1;
        if (ry < 0 || rx < 0 || ry >= kRaw || rx >= kRaw) continue;
        const unsigned u = (words[e >> 2] >> (8 * (e & 3))) & 0xffu;
        raw[(ry * kRawW + rx) * kRawPix + k] =
            __float2bfloat16_rn((static_cast<float>(u) - 127.5f) * 0.0078125f);  // exact
      }
    }
    __syncthreads();
    conv_mma<CP, true, true>(buf_a, kRawW, buf_b, kC1, kNt, CP, s_f1, s_b1, 2 * i0 - 3,
                             2 * j0 - 3, map_h, map_w, 0.0f);
    __syncthreads();
    conv_mma<CP, false, true>(buf_b, kC1, buf_a, kC2, kNt, CP, s_f2, s_b2, 2 * i0 - 2,
                              2 * j0 - 2, map_h, map_w, 0.0f);
    __syncthreads();
    conv_mma<CP, false, false>(buf_a, kC2, buf_b, kC3, n3, 2 * sw, s_f3, s_b3, 2 * i0 - 1,
                               2 * j0 - 1, map_h, map_w, -INFINITY);
    __syncthreads();

    // 3x3/2 max-pool: pooled (py, px) reads conv3 rows/cols 2p .. 2p+2; one
    // item a (pixel, channel pair).  The next tile writes buffer B only
    // after two more barriers.
    const __nv_bfloat162* c3 = reinterpret_cast<const __nv_bfloat162*>(buf_b);
    __nv_bfloat162* yo = reinterpret_cast<__nv_bfloat162*>(y);
    for (int it = threadIdx.x; it < kTile * kTile * sw; it += kMmaThreads) {
      const int p = it / sw, cp = it - (it / sw) * sw;
      const int py = p / kTile, px = p % kTile;
      const int gy = i0 + py, gx = j0 + px;
      if (gy >= h4 || gx >= w4) continue;
      const __nv_bfloat162* src = c3 + ((2 * py) * kC3 + 2 * px) * sw + cp;
      __nv_bfloat162 m = src[0];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) m = __hmax2(m, src[(dy * kC3 + dx) * sw]);
      }
      yo[((static_cast<size_t>(frame) * h4 + gy) * w4 + gx) * sw + cp] = m;
    }
  }
}

int round16(int v) { return (v + 15) / 16 * 16; }

template <int CP>
int launch_mma(const void* x, const void* f1, const void* b1, const void* f2, const void* b2,
               const void* f3, const void* b3, void* y, int b, int h4, int w4, int sw,
               cudaStream_t s) {
  const int ks = 9 * (CP / 16);
  const int frag_bytes = (3 * (CP / 8) + ks * (CP / 8) + ks * (sw / 4)) * 32 * 8;
  const int bias_bytes = 4 * CP * 4;
  const int raw = kRawBytes, c2 = kC2 * kC2 * CP * 2;
  const int c1 = kC1 * kC1 * CP * 2, c3 = kC3 * kC3 * 2 * sw * 2;
  const int size_a = round16(raw > c2 ? raw : c2);  // raw tile, then conv2
  const int size_b = round16(c1 > c3 ? c1 : c3);    // conv1, then conv3
  const int bytes = frag_bytes + bias_bytes + size_a + size_b;
  cudaError_t err = cudaFuncSetAttribute(fused_stem_mma_kernel<CP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_stem_mma_kernel<CP>,
                                                      kMmaThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = b * ((h4 + kTile - 1) / kTile) * ((w4 + kTile - 1) / kTile);
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  fused_stem_mma_kernel<CP><<<grid, kMmaThreads, bytes, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint2*>(f1),
      static_cast<const float*>(b1), static_cast<const uint2*>(f2),
      static_cast<const float*>(b2), static_cast<const uint2*>(f3),
      static_cast<const float*>(b3), static_cast<__nv_bfloat16*>(y), b, h4, w4, sw, size_a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32: x [b, h4, w4, 48] u8 s2d4 frames; w1 [3,3,3,sw], w2 [3,3,sw,sw],
// w3 [3,3,sw,2sw] (HWIO, BN folded) f32; b1..b3 f32; y [b, h4, w4, 2sw] f32.
// All contiguous; sw a multiple of 4.
extern "C" int fre_fused_stem(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* w3, const void* b3, void* y, int b,
                              int h4, int w4, int sw, void* stream) {
  if (b <= 0 || h4 <= 0 || w4 <= 0) return 0;
  if (sw <= 0 || sw % kG != 0 || b > 65535 || h4 > 65535 * kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_f32(x, w1, b1, w2, b2, w3, b3, y, b, h4, w4, sw,
                    static_cast<cudaStream_t>(stream));
}

// bf16 on the tensor cores: x as above (16-byte aligned); f1..f3 the
// BN-folded weights in fragment order (pack_stem_fragments), b1..b3 f32;
// y [b, h4, w4, 2sw] bf16.  sw a multiple of 4, at most 32.
extern "C" int fre_fused_stem_bf16(const void* x, const void* f1, const void* b1,
                                   const void* f2, const void* b2, const void* f3,
                                   const void* b3, void* y, int b, int h4, int w4, int sw,
                                   void* stream) {
  if (b <= 0 || h4 <= 0 || w4 <= 0) return 0;
  const long long tiles = static_cast<long long>(b) * ((h4 + kTile - 1) / kTile) *
                          ((w4 + kTile - 1) / kTile);
  if (sw <= 0 || sw % 4 != 0 || sw > 32 || tiles > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sw <= 16) return launch_mma<16>(x, f1, b1, f2, b2, f3, b3, y, b, h4, w4, sw, s);
  return launch_mma<32>(x, f1, b1, f2, b2, f3, b3, y, b, h4, w4, sw, s);
}
