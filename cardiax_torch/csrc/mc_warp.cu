// K1: multi-channel clamped bilinear warp, forward.
//
// Replaces cardiax/ops/warp_pallas.py:_mc_tap_kernel (launched through
// _run_mc_fwd / bilinear_warp_banded_multi). On the TPU that kernel sweeps a
// (2R+1)^2 band of rolled image copies because TPUs gather poorly; at most
// 2x2 of those taps carry weight, so here each thread gathers its four
// bilinear taps directly.
//
//   out[n, c, i, j] = bilinear(img[n, c], i + clamp(dy), j + clamp(dx))
//
// with the displacement clamped to +-(R-1), the sample coordinate clipped
// to [0, H-1] x [0, W-1] and y1 = min(y0 + 1, H - 1) (x likewise), exactly
// as cardiax/ops/warp_pallas.py:_window_coords.
//
// Bound on the H100: bytes. Each output pixel reads dy, dx and four taps
// per channel and writes one value per channel, about 14 flops per channel;
// the minimum traffic is (C + 2) planes read and C planes written. Design:
// one thread per (n, i, j), consecutive threads on consecutive pixels so the
// dy/dx loads and the stores coalesce; the displacement and the weights are
// computed once and reused across the channel loop; the four taps of
// neighbouring threads overlap, so they hit L1/L2 rather than DRAM. f32
// arithmetic and accumulation throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void mc_warp_fwd_kernel(const float* __restrict__ img,
                                   const float* __restrict__ disp,
                                   float* __restrict__ out,
                                   int64_t n_pix, int c, int h, int w,
                                   float r) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_pix) return;
  const int64_t hw = (int64_t)h * w;
  const int64_t n = idx / hw;
  const int64_t p = idx - n * hw;
  const int i = (int)(p / w);
  const int j = (int)(p - (int64_t)i * w);

  const float* d = disp + n * 2 * hw;
  const float dy = fminf(fmaxf(d[p], -r), r);
  const float dx = fminf(fmaxf(d[hw + p], -r), r);
  const float cy = fminf(fmaxf((float)i + dy, 0.0f), (float)(h - 1));
  const float cx = fminf(fmaxf((float)j + dx, 0.0f), (float)(w - 1));
  const float y0 = floorf(cy);
  const float x0 = floorf(cx);
  const float fy = cy - y0;
  const float fx = cx - x0;
  const int iy0 = (int)y0;
  const int ix0 = (int)x0;
  const int iy1 = min(iy0 + 1, h - 1);
  const int ix1 = min(ix0 + 1, w - 1);
  const float wy0 = 1.0f - fy, wx0 = 1.0f - fx;

  const float* src = img + n * c * hw;
  float* dst = out + n * c * hw;
  for (int ch = 0; ch < c; ++ch, src += hw, dst += hw) {
    const float* r0 = src + (int64_t)iy0 * w;
    const float* r1 = src + (int64_t)iy1 * w;
    // column x0 then column x1, rows y0 then y1: the tap order of the
    // TPU kernel's band sweep
    const float col0 = wy0 * __ldg(r0 + ix0) + fy * __ldg(r1 + ix0);
    const float col1 = wy0 * __ldg(r0 + ix1) + fy * __ldg(r1 + ix1);
    dst[p] = wx0 * col0 + fx * col1;
  }
}

}  // namespace

// img (N, C, H, W), disp (N, 2, H, W) [dy, dx], out (N, C, H, W); all f32,
// contiguous, on the current device. Returns cudaGetLastError().
extern "C" int mc_warp_fwd(const float* img, const float* disp, float* out,
                           int n, int c, int h, int w, int radius,
                           cudaStream_t stream) {
  const int64_t n_pix = (int64_t)n * h * w;
  if (n_pix == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n_pix + threads - 1) / threads;
  mc_warp_fwd_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      img, disp, out, n_pix, c, h, w, (float)(radius - 1));
  return (int)cudaGetLastError();
}
