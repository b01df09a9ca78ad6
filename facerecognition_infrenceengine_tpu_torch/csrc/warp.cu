// K3: two-pass sheared-hat face warp, read straight from the pyramid atlas
// (raw NHWC or s2d4-packed, uint8 or float32) into out x out float32 crops
// (112 for the embedder, 96 and 192 for the attribute heads), for sm_90a.
//
// Replaces the TPU kernel facerecognition_infrenceengine_tpu/ops/
// warp_pallas.py::warp_rois_pallas (body _warp_kernel).  Same function, on
// each face's R x R window of the atlas (R = 192: the ROI):
//   pass 1  tmp[y, j]  = sum_x win[y, x] * hat(clamp(u(y, j)) - x)
//           u(y, j)    = (m00 - m01*m10/m11)*j + (m01/m11)*y + (m02 - m01*m12/m11)
//   pass 2  out[i, j]  = sum_y tmp[y, j] * hat(clamp(sy(i, j)) - y)
//           sy(i, j)   = m10*j + m11*i + m12
// with coordinates clamped to [0, R-1] (border replicate) and |m11| kept
// at 1e-6 or more.  A window is (frame, row origin, column origin) in atlas
// units; on the packed atlas those are packed pixels and raw window pixel
// (y, x, c) sits at packed pixel (y/4, x/4), channel ((y%4)*4 + x%4)*C + c.
// warp_rois is the case where the atlas is the [M, R, R, C] float32 ROI
// stack itself, with window k = (k, 0, 0) (windows == nullptr).
//
// Bound on the H100: bytes.  Per output pixel the work is a few dozen
// flops; the floor is reading the atlas bytes the taps reach (uint8: C
// bytes a window pixel) plus the windows and affines, and writing the
// float32 crops: M*out*out*C*4 bytes, most of the bound at every size
// (113 MB at out 192, M = 256, ~34 us at 3.35 TB/s).
//
// Design: no ROI tensor.  The earlier form gathered every face's window
// into a [M, 192, 192, C] float32 tensor first (a uint8 gather, then a
// float copy: ~140 MB of traffic at M = 256 before the kernel started) and
// read its taps from there.  Here the taps are read from the atlas itself.
// A warp takes a tile of 4 output rows x 32 columns, a block 8 such tiles
// of one face; thread 0 computes the face's constants a1, b1, c1 and its
// window once for the block.  (A strip of 128 pixels of one row reaches
// ~60 window rows on a face rotated by 0.5 rad, a taller tile fewer; 4 rows
// measured best over 1, 2, 4 and 8 on rotated faces and on boxes.)
// Each hat has two non-zero taps, so the two passes are evaluated per
// output pixel as a gather of four window pixels per channel, with
// round-to-nearest intrinsics that are never fused otherwise: taps, weights
// and sums are bit-identical whichever layout or element type the window
// comes from (uint8 -> float32 is exact), and taps and weights equal the
// plain version's.  A thread takes 4 adjacent pixels of a row, keeps
// their 48 byte loads in flight at once, and writes their 12 floats as
// three aligned 16-byte stores.  The direct form uses no shared memory and
// 32 registers (capped by the launch bounds: 40 measured slower), so 64
// warps fit an SM; the forms below that held more in shared memory fit
// fewer and were slower, though they did less arithmetic.
//
// Tried on an H100 and measured no faster than this form at out 192 and 112:
//   - a block per (face, band of 16 output rows), 12 pixels a thread, the
//     band's crops formed in shared memory and copied out as coalesced
//     16-byte stores (the shared memory cut the blocks an SM);
//   - the same with pass 1 formed once per (window row, column) in shared
//     memory and pass 2 reading two of its rows a pixel: fewer operations,
//     but the phases' barriers and the larger shared memory cost more;
//   - the uint8 -> float, floor and float -> int conversions done exactly
//     on the FMA pipe ((2**23 + b) - 2**23, v + 2**23 rounded down): no
//     faster, so the conversion unit is not what bounds the kernel;
//   - staged (kept as variant 1, timed beside direct in chip_smoke.py):
//     the block copies the window rows its pixels' taps can reach (bounded
//     by the images of its rows' corners plus one tap row, at most
//     kStageRows) into shared memory with 16-byte cp.async chunks, the raw
//     rows' starts aligned down to 16 bytes, and reads its taps there (a
//     block that reaches more rows reads global memory).
// float32 atlases always read direct (a 192 x 192 x 3 float window is
// 442 KB, twice a block's shared memory).
//
// Why not the tensor cores: the TPU kernel contracts dense hat matrices
// on the MXU.  On Hopper that is ~96x the MACs needed (2 non-zero taps in
// 192), and TF32 or bf16 operands at the 0..255 pixel scale miss K3's 1e-3
// tolerance by two orders of magnitude.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4;
constexpr int kPix = 4;              // adjacent output pixels a thread
constexpr int kTileRows = 4;         // a warp's tile: 4 output rows x 32 columns
constexpr int kTileCols = 32 / kTileRows * kPix;
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 24;       // raw window rows a staged block holds (6 packed)

struct Face {
  float a1, b1, c1, m10, m11, m12;
  long long base;   // atlas element offset of window pixel (0, 0), channel 0
  int lo, rows;     // staged: first raw window row held, rows held (0: direct)
};

__device__ __forceinline__ float clamp_coord(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

__device__ __forceinline__ float hat(float c, float idx) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(c, idx))));
}

__device__ __forceinline__ float sample_y(const Face& f, int i, int j) {
  return __fadd_rn(__fadd_rn(__fmul_rn(f.m10, static_cast<float>(j)),
                             __fmul_rn(f.m11, static_cast<float>(i))), f.m12);
}

// element offset of window pixel (y, x) from the window's pixel (0, 0): a row
// part and a column part; pitch is the atlas row in elements
template <bool kPacked>
__device__ __forceinline__ long long row_off(int y, long long pitch, int c) {
  return kPacked ? static_cast<long long>(y >> 2) * pitch + (y & 3) * 4 * c
                 : static_cast<long long>(y) * pitch;
}

template <bool kPacked>
__device__ __forceinline__ int col_off(int x, int c) {
  return kPacked ? ((x >> 2) * 16 + (x & 3)) * c : x * c;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Raw staged rows: row k of the stage starts at k * raw_pitch(r, c) bytes and
// holds the atlas bytes from the row's start aligned down to 16.
__host__ __device__ __forceinline__ int raw_pitch(int r, int c) {
  return (r * c + 30) / 16 * 16;
}

__host__ __device__ __forceinline__ int stage_bytes(bool packed, int r, int c) {
  return packed ? (kStageRows / 4) * 4 * r * c : kStageRows * raw_pitch(r, c);
}

// Output pixel (i, j), all channels: both passes, the taps of rows
// floor(sy) and floor(sy) + 1; row(y) is window row y's first element.
template <typename T, bool kPacked, int kC, typename Row>
__device__ __forceinline__ void pixel(const Face& f, const Row& row, int c, int r, float rmax,
                                      int i, int j, float* acc) {
  const float jf = static_cast<float>(j);
  const float syc = clamp_coord(sample_y(f, i, j), rmax);
  const float y0f = floorf(syc);
#pragma unroll
  for (int ch = 0; ch < (kC ? kC : kMaxChannels); ++ch) acc[ch] = 0.0f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float yf = y0f + static_cast<float>(t);
    const float wy = hat(syc, yf);
    // wy is 0 for the row past R-1 when syc clamps to R-1: never read it.
    if (wy == 0.0f) continue;
    const float u = __fadd_rn(__fadd_rn(__fmul_rn(f.a1, jf), __fmul_rn(f.b1, yf)), f.c1);
    const float uc = clamp_coord(u, rmax);
    const float x0f = floorf(uc);
    const float wx0 = hat(uc, x0f);
    const float wx1 = hat(uc, x0f + 1.0f);  // 0 when uc clamps to R-1
    const int x0 = static_cast<int>(x0f);
    const int x1 = min(x0 + 1, r - 1);
    const T* base = row(static_cast<int>(yf));
    const T* p0 = base + col_off<kPacked>(x0, c);
    const T* p1 = base + col_off<kPacked>(x1, c);
#pragma unroll
    for (int ch = 0; ch < (kC ? kC : kMaxChannels); ++ch) {
      if (kC || ch < c) {
        const float tmp = __fmaf_rn(wx0, static_cast<float>(p0[ch]),
                                    __fmul_rn(wx1, static_cast<float>(p1[ch])));
        acc[ch] = __fmaf_rn(wy, tmp, acc[ch]);
      }
    }
  }
}

template <typename T, bool kPacked, bool kStaged, int kC>
__global__ void __launch_bounds__(kThreads, 8)  // 32 registers: 64 warps an SM
warp_windows_kernel(const T* __restrict__ atlas,      // [B, Ha, Wa, C or 16C]
                    const int* __restrict__ windows,  // [M, 3] or nullptr
                    const float* __restrict__ mats,   // [M, 2, 3] dst -> window
                    float* __restrict__ out,          // [M, out, out, C]
                    int b, int ha, int wa, int c_arg, int r, int out_size,
                    long long atlas_elems) {
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ Face face_s;
  __shared__ int shift_s[kStageRows];  // raw staged row k's first byte in its stage row
  const int c = kC ? kC : c_arg;
  // a warp takes one tile of output pixels, a block kWarps consecutive tiles
  // (row-major) of one face
  const int tiles_x = (out_size + kTileCols - 1) / kTileCols;
  const int tiles = tiles_x * ((out_size + kTileRows - 1) / kTileRows);
  const int parts = (tiles + kWarps - 1) / kWarps;
  const int face = blockIdx.x / parts;
  const int tile0 = (blockIdx.x - face * parts) * kWarps;  // the block's first tile
  const int cs = kPacked ? 16 * c : c;
  const float rmax = static_cast<float>(r - 1);

  if (threadIdx.x == 0) {
    Face f;
    const float* m = mats + static_cast<long long>(face) * 6;
    const float m00 = m[0], m01 = m[1], m02 = m[2];
    f.m10 = m[3];
    f.m12 = m[5];
    f.m11 = fabsf(m[4]) < 1e-6f ? 1e-6f : m[4];
    f.a1 = __fsub_rn(m00, __fdiv_rn(__fmul_rn(m01, f.m10), f.m11));
    f.b1 = __fdiv_rn(m01, f.m11);
    f.c1 = __fsub_rn(m02, __fdiv_rn(__fmul_rn(m01, f.m12), f.m11));
    int frame = face, oy = 0, ox = 0;
    if (windows != nullptr) {  // clamped into the atlas: never read outside it
      const int side = kPacked ? r / 4 : r;
      frame = min(max(windows[face * 3], 0), b - 1);
      oy = min(max(windows[face * 3 + 1], 0), ha - side);
      ox = min(max(windows[face * 3 + 2], 0), wa - side);
    }
    f.base = ((static_cast<long long>(frame) * ha + oy) * wa + ox) * cs;
    f.lo = 0;
    f.rows = 0;
    if (kStaged) {
      // the block's output rows; sy is monotone in i and in j (each rounding
      // step is), so its taps lie between the rows of its corners' images
      const int ia = tile0 / tiles_x * kTileRows;
      const int ib = min((min(tile0 + kWarps, tiles) - 1) / tiles_x * kTileRows + kTileRows,
                         out_size) - 1;
      float lo = rmax, hi = 0.0f;
      for (int corner = 0; corner < 4; ++corner) {
        const float syc = clamp_coord(sample_y(f, (corner & 1) ? ib : ia,
                                               (corner >> 1) * (out_size - 1)), rmax);
        lo = fminf(lo, syc);
        hi = fmaxf(hi, syc);
      }
      int ylo = static_cast<int>(floorf(lo));
      const int yhi = min(static_cast<int>(floorf(hi)) + 1, r - 1);
      if (kPacked) ylo &= ~3;
      const int rows = kPacked ? ((yhi >> 2) - (ylo >> 2) + 1) * 4 : yhi - ylo + 1;
      if (rows <= kStageRows) {
        f.lo = ylo;
        f.rows = rows;
      }
    }
    face_s = f;
  }
  __syncthreads();
  const Face f = face_s;

  if (kStaged && f.rows > 0) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(atlas);
    if (kPacked) {
      // a packed row (4 raw rows) is r*4*c contiguous bytes, 16-byte aligned
      const int chunks = r * c / 4;
      const int n = (f.rows / 4) * chunks;
      for (int k = threadIdx.x; k < n; k += kThreads) {
        const int prow = k / chunks, chunk = k - prow * chunks;
        const long long g = f.base + (static_cast<long long>((f.lo >> 2) + prow) * wa) * cs
                            + chunk * 16;
        cp_async16(stage + prow * 4 * r * c + chunk * 16, src + g, 16);
      }
    } else {
      const int pitch = raw_pitch(r, c);
      const int per_row = pitch / 16;
      const int n = f.rows * per_row;
      for (int k = threadIdx.x; k < n; k += kThreads) {
        const int row = k / per_row, chunk = k - row * per_row;
        const long long start = f.base + static_cast<long long>(f.lo + row) * wa * c;
        const long long g = (start & ~15LL) + chunk * 16;
        if (chunk == 0) shift_s[row] = static_cast<int>(start & 15);
        // zero-filled past the atlas's last byte
        const long long left = atlas_elems - g;
        const int bytes = left >= 16 ? 16 : (left > 0 ? static_cast<int>(left) : 0);
        cp_async16(stage + row * pitch + chunk * 16, src + (bytes > 0 ? g : 0), bytes);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  const long long pitch = static_cast<long long>(wa) * cs;
  auto row = [&](int y) -> const T* {
    if (kStaged && f.rows > 0) {
      const int k = y - f.lo;
      const unsigned char* s = kPacked ? stage + (k >> 2) * 4 * r * c + (k & 3) * 4 * c
                                       : stage + k * raw_pitch(r, c) + shift_s[k];
      return reinterpret_cast<const T*>(s);
    }
    return atlas + f.base + row_off<kPacked>(y, pitch, c);
  };

  // this thread's kPix adjacent pixels: row i, columns j .. j + kPix - 1
  const int tile = tile0 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int i = tile / tiles_x * kTileRows + lane / (32 / kTileRows);
  const int j = (tile % tiles_x) * kTileCols + lane % (32 / kTileRows) * kPix;
  if (tile >= tiles || i >= out_size || j >= out_size) return;
  float* dst = out + ((static_cast<long long>(face) * out_size + i) * out_size + j) * c;
  if (kC == 3 && out_size % kPix == 0) {
    // 12 floats, three aligned 16-byte stores
    float acc[kPix * 3];
#pragma unroll
    for (int k = 0; k < kPix; ++k) pixel<T, kPacked, kC>(f, row, c, r, rmax, i, j + k, acc + 3 * k);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d4[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
  } else {
    for (int k = 0; k < kPix && j + k < out_size; ++k) {
      float acc[kMaxChannels];
      pixel<T, kPacked, kC>(f, row, c, r, rmax, i, j + k, acc);
      for (int ch = 0; ch < c; ++ch) dst[k * c + ch] = acc[ch];
    }
  }
}

template <typename T, bool kPacked, bool kStaged, int kC>
int launch_c(const void* atlas, const int* windows, const float* mats, float* out, int m,
             int b, int ha, int wa, int c, int r, int out_size, cudaStream_t stream) {
  const int smem = kStaged ? stage_bytes(kPacked, r, c) : 0;
  auto kernel = warp_windows_kernel<T, kPacked, kStaged, kC>;
  // the opt-in above 48 KB, static shared memory included (per device: set
  // every call)
  if (smem + static_cast<int>(sizeof(Face)) + kStageRows * 4 > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long elems = static_cast<long long>(b) * ha * wa * (kPacked ? 16 * c : c);
  const int tiles = ((out_size + kTileCols - 1) / kTileCols)
                    * ((out_size + kTileRows - 1) / kTileRows);
  const long long blocks = static_cast<long long>(m) * ((tiles + kWarps - 1) / kWarps);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(atlas), windows, mats, out, b, ha, wa, c, r, out_size, elems);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kPacked, bool kStaged>
int launch(const void* atlas, const int* windows, const float* mats, float* out, int m, int b,
           int ha, int wa, int c, int r, int out_size, cudaStream_t stream) {
  // RGB, the port's only layout, with the channel count known at compile time
  return c == 3 ? launch_c<T, kPacked, kStaged, 3>(atlas, windows, mats, out, m, b, ha, wa, c,
                                                    r, out_size, stream)
                : launch_c<T, kPacked, kStaged, 0>(atlas, windows, mats, out, m, b, ha, wa, c,
                                                    r, out_size, stream);
}

}  // namespace

// variant: the uint8 read, 0 direct, 1 staged; float32 reads direct whatever
// the variant.
extern "C" int fre_warp_windows(const void* atlas, const int* windows, const float* mats,
                                float* out, int m, int b, int ha, int wa, int c, int r,
                                int out_size, int is_u8, int packed, int variant,
                                void* stream) {
  if (m <= 0) return 0;
  const int side = packed ? r / 4 : r;
  if (c < 1 || c > kMaxChannels || r < 1 || out_size < 1 || b < 1 || variant < 0
      || variant > 1 || (packed && r % 4 != 0) || side > ha || side > wa
      || out_size > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = variant == 1;
  if (!is_u8)
    return packed ? launch<float, true, false>(atlas, windows, mats, out, m, b, ha, wa, c, r,
                                               out_size, s)
                  : launch<float, false, false>(atlas, windows, mats, out, m, b, ha, wa, c, r,
                                                out_size, s);
  if (packed)
    return staged ? launch<uint8_t, true, true>(atlas, windows, mats, out, m, b, ha, wa, c, r,
                                                out_size, s)
                  : launch<uint8_t, true, false>(atlas, windows, mats, out, m, b, ha, wa, c, r,
                                                 out_size, s);
  return staged ? launch<uint8_t, false, true>(atlas, windows, mats, out, m, b, ha, wa, c, r,
                                               out_size, s)
                : launch<uint8_t, false, false>(atlas, windows, mats, out, m, b, ha, wa, c, r,
                                                out_size, s);
}

extern "C" int fre_warp_windows_stage_rows() { return kStageRows; }
