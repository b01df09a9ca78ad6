// K3: two-pass sheared-hat face warp, ROI -> out x out crop (112 for the
// embedder, 96 and 192 for the attribute heads), for sm_90a.
//
// Replaces the TPU kernel facerecognition_infrenceengine_tpu/ops/
// warp_pallas.py::warp_rois_pallas (body _warp_kernel).  Same function:
//   pass 1  tmp[y, j]  = sum_x roi[y, x] * hat(clamp(u(y, j)) - x)
//           u(y, j)    = (m00 - m01*m10/m11)*j + (m01/m11)*y + (m02 - m01*m12/m11)
//   pass 2  out[i, j]  = sum_y tmp[y, j] * hat(clamp(sy(i, j)) - y)
//           sy(i, j)   = m10*j + m11*i + m12
// with coordinates clamped to [0, R-1] (border replicate) and |m11| kept
// at 1e-6 or more.
//
// Bound on the H100: bytes.  Per output pixel the work is a few dozen
// flops, so the floor is reading the f32 ROIs and writing the f32 crops
// (M*(192*192 + 112*112)*C*4 bytes, ~152 MB at M=256, ~45 us at 3.35 TB/s).
//
// Design: the TPU kernel contracts dense hat-weight matrices on the MXU and
// keeps a [R, C, out] pass-1 intermediate in VMEM; here that intermediate
// (258 KB for C=3) would not fit a block's 227 KB of shared memory.  Each
// hat has two non-zero taps, so the two-pass function is evaluated per
// output pixel as a gather: two rows y around clamp(sy), and in each of
// those rows two columns around clamp(u(y, j)) -- four ROI reads per
// channel, one thread per output pixel, no intermediate at all.  It reads
// only the sampled part of each ROI.  The coordinate arithmetic uses
// round-to-nearest intrinsics, which are never fused into FMAs, so the taps
// and weights are bit-identical to the plain PyTorch version's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4;

__device__ __forceinline__ float clamp_coord(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

__device__ __forceinline__ float hat(float c, float idx) {
  return fmaxf(0.0f, 1.0f - fabsf(c - idx));
}

__global__ void __launch_bounds__(kThreads)
warp_rois_kernel(const float* __restrict__ rois,  // [M, R, R, C] contiguous
                 const float* __restrict__ mats,  // [M, 2, 3] dst -> roi
                 float* __restrict__ out,         // [M, out, out, C]
                 int r, int c, int out_size) {
  const int face = blockIdx.y;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= out_size * out_size) return;
  const int i = pix / out_size;
  const int j = pix - i * out_size;

  const float* m = mats + face * 6;
  const float m00 = m[0], m01 = m[1], m02 = m[2];
  const float m10 = m[3], m12 = m[5];
  const float m11 = fabsf(m[4]) < 1e-6f ? 1e-6f : m[4];
  const float a1 = __fsub_rn(m00, __fdiv_rn(__fmul_rn(m01, m10), m11));
  const float b1 = __fdiv_rn(m01, m11);
  const float c1 = __fsub_rn(m02, __fdiv_rn(__fmul_rn(m01, m12), m11));

  const float jf = static_cast<float>(j);
  const float rmax = static_cast<float>(r - 1);
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(m10, jf),
                                       __fmul_rn(m11, static_cast<float>(i))), m12);
  const float syc = clamp_coord(sy, rmax);
  const float y0f = floorf(syc);

  float acc[kMaxChannels] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float* roi = rois + static_cast<size_t>(face) * r * r * c;
  for (int t = 0; t < 2; ++t) {
    const float yf = y0f + static_cast<float>(t);
    const float wy = hat(syc, yf);
    // wy is 0 for the row past R-1 when syc clamps to R-1: never read it.
    if (wy == 0.0f) continue;
    const float u = __fadd_rn(__fadd_rn(__fmul_rn(a1, jf), __fmul_rn(b1, yf)), c1);
    const float uc = clamp_coord(u, rmax);
    const float x0f = floorf(uc);
    const float wx0 = hat(uc, x0f);
    const float wx1 = hat(uc, x0f + 1.0f);  // 0 when uc clamps to R-1
    const int x0 = static_cast<int>(x0f);
    const int x1 = min(x0 + 1, r - 1);
    const float* row = roi + static_cast<size_t>(static_cast<int>(yf)) * r * c;
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch) {
      if (ch < c) {
        const float tmp = wx0 * row[x0 * c + ch] + wx1 * row[x1 * c + ch];
        acc[ch] += wy * tmp;
      }
    }
  }
  float* o = out + (static_cast<size_t>(face) * out_size * out_size + pix) * c;
#pragma unroll
  for (int ch = 0; ch < kMaxChannels; ++ch) {
    if (ch < c) o[ch] = acc[ch];
  }
}

}  // namespace

extern "C" int fre_warp_rois(const float* rois, const float* mats, float* out,
                             int m, int r, int c, int out_size, void* stream) {
  if (m <= 0) return 0;
  if (c < 1 || c > kMaxChannels || m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((out_size * out_size + kThreads - 1) / kThreads, m);
  warp_rois_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rois, mats, out, r, c, out_size);
  return static_cast<int>(cudaGetLastError());
}
