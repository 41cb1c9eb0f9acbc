// K1: multi-channel clamped bilinear warp, forward; K4 (below): its
// displacement backward.
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

#include <algorithm>

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

// K4: d/d disp of the warp above, summed over channels; no d/d img.
//
// Replaces cardiax/ops/warp_pallas.py:_mc_disp_bwd_kernel (the final warp's
// VJP with img_const=True: the warped field is data). With I_c the field's
// channel c at the four taps and g_c the cotangent,
//
//   gdy = my * sum_c g_c [(1-fx)(I(y1,x0) - I(y0,x0)) + fx(I(y1,x1) - I(y0,x1))]
//   gdx = mx * sum_c g_c [(1-fy)(I(y0,x1) - I(y0,x0)) + fy(I(y1,x1) - I(y1,x0))]
//
// where my/mx are 1 only where neither the clamp nor the clip bites, tested
// on the unclamped displacement (warp_pallas.py:_window_coords), and the
// d/d coordinate is 0 where the clip holds both taps on the last row or
// column (y1 == y0: warp_pallas.py:_dhat). Terms are summed in the band
// sweep's order: column x0 over channels, then column x1 over channels.
//
// Bound on the H100: bytes. Reads disp (2 planes), the field and g (C planes
// each), writes 2 planes; about 20 flops per channel. Same design as the
// forward: one thread per pixel, coalesced plane reads and writes, the four
// gathered taps of neighbouring threads served by L1/L2.
__device__ __forceinline__ void disp_grad_at(
    const float* __restrict__ img, const float* __restrict__ disp,
    const float* __restrict__ g, float* __restrict__ gdisp, int64_t n,
    int64_t p, int i, int j, int c, int h, int w, float r) {
  const int64_t hw = (int64_t)h * w;
  const float* d = disp + n * 2 * hw;
  const float dy_raw = d[p], dx_raw = d[hw + p];
  const float fi = (float)i, fj = (float)j;
  const float cy = fminf(fmaxf(fi + fminf(fmaxf(dy_raw, -r), r), 0.0f),
                         (float)(h - 1));
  const float cx = fminf(fmaxf(fj + fminf(fmaxf(dx_raw, -r), r), 0.0f),
                         (float)(w - 1));
  const float y0 = floorf(cy), x0 = floorf(cx);
  const float fy = cy - y0, fx = cx - x0;
  const int iy0 = (int)y0, ix0 = (int)x0;
  const int iy1 = min(iy0 + 1, h - 1), ix1 = min(ix0 + 1, w - 1);
  const float wy0 = 1.0f - fy, wx0 = 1.0f - fx;
  // d hat / d x on the two columns: -1, +1, or 0 for both when x1 == x0
  const float sx = ix1 != ix0 ? 1.0f : 0.0f;
  const float my = (fabsf(dy_raw) <= r && fi + dy_raw >= 0.0f
                    && fi + dy_raw <= (float)(h - 1)) ? 1.0f : 0.0f;
  const float mx = (fabsf(dx_raw) <= r && fj + dx_raw >= 0.0f
                    && fj + dx_raw <= (float)(w - 1)) ? 1.0f : 0.0f;

  const int64_t o00 = (int64_t)iy0 * w + ix0, o01 = (int64_t)iy0 * w + ix1;
  const int64_t o10 = (int64_t)iy1 * w + ix0, o11 = (int64_t)iy1 * w + ix1;
  const float* src0 = img + n * c * hw;
  const float* g0 = g + n * c * hw;
  float acc_dy = 0.0f, acc_dx = 0.0f;
  for (int ch = 0; ch < c; ++ch) {            // column x0
    const float* s = src0 + ch * hw;
    const float gc = __ldg(g0 + ch * hw + p);
    const float a = __ldg(s + o00), b = __ldg(s + o10);
    acc_dy += (wx0 * gc) * (b - a);
    acc_dx += (-sx * gc) * (wy0 * a + fy * b);
  }
  for (int ch = 0; ch < c; ++ch) {            // column x1
    const float* s = src0 + ch * hw;
    const float gc = __ldg(g0 + ch * hw + p);
    const float a = __ldg(s + o01), b = __ldg(s + o11);
    acc_dy += (fx * gc) * (b - a);
    acc_dx += (sx * gc) * (wy0 * a + fy * b);
  }
  float* out = gdisp + n * 2 * hw;
  out[p] = acc_dy * my;
  out[hw + p] = acc_dx * mx;
}

__global__ void mc_warp_disp_bwd_kernel(const float* __restrict__ img,
                                        const float* __restrict__ disp,
                                        const float* __restrict__ g,
                                        float* __restrict__ gdisp,
                                        int64_t n_pix, int c, int h, int w,
                                        float r) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_pix) return;
  const int64_t hw = (int64_t)h * w;
  const int64_t n = idx / hw;
  const int64_t p = idx - n * hw;
  const int i = (int)(p / w);
  const int j = (int)(p - (int64_t)i * w);
  disp_grad_at(img, disp, g, gdisp, n, p, i, j, c, h, w, r);
}

// K5: the warp's full backward, per-channel d/d field plus (optionally) K4's
// channel-summed d/d disp, in one launch.
//
// Replaces cardiax/ops/warp_pallas.py:_mc_fused_bwd_kernel (B5), and at
// C = 1 the single-channel _transpose_kernel (B7), _fused_bwd_kernel (B8)
// and _tiled_transpose_kernel (B10). The d/d field is the warp's adjoint:
//
//   gfield[n, c, q] = sum_p g[n, c, p] * hat_y(q_y; p) * hat_x(q_x; p)
//
// with the hat weights of source pixel p's clamped, clipped coordinate
// (both terms add where y1 == y0: warp_pallas.py:_hat). The TPU scatters by
// rolling weighted copies of g over the (2R+1)^2 band; a scatter here would
// need float atomics, whose sum order changes from run to run. So each
// thread gathers instead, as K3 does: output pixel q visits every source
// p = q - (d, e) whose taps can reach it, recomputes p's coordinate and adds
// hat_y * (g * hat_x), columns e outer and rows d inner -- the order of the
// band sweep, so the sum is that of the plain version term for term.
//
// Bound on the H100: bytes (disp, the field and g read, both outputs
// written: 3C + 4 planes) -- but a gather over the full band visits
// (2R+1)^2 sources per output pixel, about 20x the byte bound at R = 12.
// Design: a first pass (warp_band_kernel) finds each item's largest clamped
// |dy| and |dx|; a source can reach a tap at most floor(max) + 1 rows or
// columns away, so the gather's band is that, not R. It skips only terms
// that are exactly zero, so the result is unchanged; for the displacements
// of a trained model (max |u| ~ 2 px) it visits 25-49 sources, not 625.
// Channels go four at a time, sharing each source's coordinate. f32
// arithmetic and accumulation.

// Clamped, clipped sample coordinate of one axis: the near tap a0, the far
// tap a1 = min(a0 + 1, n - 1) and the fraction f.
struct Axis { int a0, a1; float f; };

__device__ __forceinline__ Axis axis_coord(int k, float b, float r, int n) {
  const float c = fminf(fmaxf((float)k + fminf(fmaxf(b, -r), r), 0.0f),
                        (float)(n - 1));
  const float c0 = floorf(c);
  const int a0 = (int)c0;
  return {a0, min(a0 + 1, n - 1), c - c0};
}

// hat weight of tap index k for coordinate (a0, a1, f): both terms add
// where a0 == a1 (warp_pallas.py:_hat)
__device__ __forceinline__ float hat(int k, Axis a) {
  return (k == a.a0 ? 1.0f - a.f : 0.0f) + (k == a.a1 ? a.f : 0.0f);
}

// band[2n + a] = floor(max over item n of min(|disp_a|, r)) + 1, for axis a
// (0 = y, 1 = x); band must be zero on entry. Grid (N, blocks, 2), whole
// warps (every lane reaches the shuffle).
__global__ void warp_band_kernel(const float* __restrict__ disp,
                                 int* __restrict__ band, int64_t hw, float r) {
  const int64_t n = blockIdx.x;
  const float* d = disp + (n * 2 + blockIdx.z) * hw;
  int b = 0;
  for (int64_t p = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; p < hw;
       p += (int64_t)gridDim.y * blockDim.x)
    // fminf drops a NaN, which then takes the full band
    b = max(b, (int)floorf(fminf(fabsf(__ldg(d + p)), r)) + 1);
  b = __reduce_max_sync(0xffffffffu, b);
  if ((threadIdx.x & 31) == 0) atomicMax(band + n * 2 + blockIdx.z, b);
}

constexpr int kChunk = 4;   // channels that share one source coordinate

__global__ void mc_warp_fused_bwd_kernel(const float* __restrict__ img,
                                         const float* __restrict__ disp,
                                         const float* __restrict__ g,
                                         const int* __restrict__ band,
                                         float* __restrict__ gimg,
                                         float* __restrict__ gdisp,
                                         int64_t n_pix, int c, int h, int w,
                                         float r) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_pix) return;
  const int64_t hw = (int64_t)h * w;
  const int64_t n = idx / hw;
  const int64_t p = idx - n * hw;
  const int i = (int)(p / w);
  const int j = (int)(p - (int64_t)i * w);
  if (gdisp != nullptr)                       // this pixel as a source
    disp_grad_at(img, disp, g, gdisp, n, p, i, j, c, h, w, r);

  // this pixel as a tap: gather the sources whose taps reach it
  const float* dy = disp + n * 2 * hw;
  const float* dx = dy + hw;
  const float* gb = g + n * c * hw;
  float* out = gimg + n * c * hw;
  const int by = __ldg(band + 2 * n), bx = __ldg(band + 2 * n + 1);
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    const int nc = min(kChunk, c - c0);
    float acc[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int e = -bx; e <= bx; ++e) {
      const int js = j - e;
      if (js < 0 || js >= w) continue;
      float be[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int d = -by; d <= by; ++d) {
        const int is = i - d;
        if (is < 0 || is >= h) continue;
        const int64_t q = (int64_t)is * w + js;
        const float hx = hat(j, axis_coord(js, __ldg(dx + q), r, w));
        if (hx == 0.0f) continue;             // a zero term: skip it
        const float hy = hat(i, axis_coord(is, __ldg(dy + q), r, h));
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          if (k < nc) be[k] += hy * (__ldg(gb + (c0 + k) * hw + q) * hx);
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) acc[k] += be[k];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (k < nc) out[(c0 + k) * hw + p] = acc[k];
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

// img (N, C, H, W), disp (N, 2, H, W), g (N, C, H, W) -> gdisp (N, 2, H, W);
// all f32, contiguous, on the current device. Returns cudaGetLastError().
extern "C" int mc_warp_disp_bwd(const float* img, const float* disp,
                                const float* g, float* gdisp, int n, int c,
                                int h, int w, int radius, cudaStream_t stream) {
  const int64_t n_pix = (int64_t)n * h * w;
  if (n_pix == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n_pix + threads - 1) / threads;
  mc_warp_disp_bwd_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      img, disp, g, gdisp, n_pix, c, h, w, (float)(radius - 1));
  return (int)cudaGetLastError();
}

// img (N, C, H, W), disp (N, 2, H, W), g (N, C, H, W) -> gimg (N, C, H, W)
// and, unless gdisp is null, gdisp (N, 2, H, W); band is int32 scratch of
// 2N entries. All f32 (band int32), contiguous, on the current device.
// Launches warp_band_kernel, then K5. Returns cudaGetLastError().
extern "C" int mc_warp_fused_bwd(const float* img, const float* disp,
                                 const float* g, float* gimg, float* gdisp,
                                 int* band, int n, int c, int h, int w,
                                 int radius, cudaStream_t stream) {
  const int64_t hw = (int64_t)h * w;
  const int64_t n_pix = (int64_t)n * hw;
  if (n_pix == 0) return (int)cudaSuccess;
  const float r = (float)(radius - 1);
  cudaError_t err = cudaMemsetAsync(band, 0, sizeof(int) * 2 * n, stream);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int64_t band_blocks = std::min<int64_t>((hw + threads - 1) / threads,
                                                64);
  warp_band_kernel<<<dim3((unsigned)n, (unsigned)band_blocks, 2), threads, 0,
                     stream>>>(disp, band, hw, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (n_pix + threads - 1) / threads;
  mc_warp_fused_bwd_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      img, disp, g, band, gimg, gdisp, n_pix, c, h, w, r);
  return (int)cudaGetLastError();
}
