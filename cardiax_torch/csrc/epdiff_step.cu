// K2: one forward Euler step of EPDiff with the semi-Lagrangian map update.
//
// Replaces cardiax/ops/epdiff_pallas.py:_fwd_kernel (launched through
// epdiff_step). Per item (2, H, W):
//
//   m' = m - dt * ad*_v m,
//   ad*_v m = (Dv)^T m + (Dm) v + m div v,
//   u' = b + warp(u, b),   b = -dt * v,
//
// with central differences that are one-sided on the borders
// (epdiff_pallas.py:_dy/_dx) and the warp of the 2-channel map u clamped to
// |b| <= radius - 1 and clipped to [0, H-1] x [0, W-1]
// (epdiff_pallas.py:_coords_local). The TPU kernel forms the derivative
// planes by rolls and sweeps a (2R+1)^2 band of rolled copies of u; here
// each thread reads its 3x3 neighbourhood of v and m and gathers its four
// bilinear taps of u directly.
//
// Bound on the H100: bytes. The minimum traffic is v, m, u read once
// (6 planes) and m', u' written once (4 planes); the arithmetic is about
// 90 flops per pixel. Design: one thread per (n, i, j), consecutive threads
// on consecutive pixels so every plane's loads and stores coalesce; the
// neighbour reads of adjacent threads overlap and are served by L1/L2, so
// DRAM sees each input about once. f32 arithmetic and accumulation, in the
// evaluation order of the TPU kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// d/dy of plane f at (i, j): central inside, one-sided on the first and
// last row (exactly cardiax/ops/shooting.py:_grad_hw).
__device__ __forceinline__ float ddy(const float* __restrict__ f, int i,
                                     int j, int h, int w) {
  if (i == 0) return __ldg(f + w + j) - __ldg(f + j);
  if (i == h - 1)
    return __ldg(f + (int64_t)i * w + j) - __ldg(f + (int64_t)(i - 1) * w + j);
  return 0.5f * (__ldg(f + (int64_t)(i + 1) * w + j)
                 - __ldg(f + (int64_t)(i - 1) * w + j));
}

__device__ __forceinline__ float ddx(const float* __restrict__ f, int i,
                                     int j, int w) {
  const float* row = f + (int64_t)i * w;
  if (j == 0) return __ldg(row + 1) - __ldg(row);
  if (j == w - 1) return __ldg(row + j) - __ldg(row + j - 1);
  return 0.5f * (__ldg(row + j + 1) - __ldg(row + j - 1));
}

__global__ void epdiff_step_fwd_kernel(const float* __restrict__ v,
                                       const float* __restrict__ m,
                                       const float* __restrict__ u,
                                       float* __restrict__ m_out,
                                       float* __restrict__ u_out,
                                       int64_t n_pix, int h, int w, float dt,
                                       float r) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_pix) return;
  const int64_t hw = (int64_t)h * w;
  const int64_t n = idx / hw;
  const int64_t p = idx - n * hw;
  const int i = (int)(p / w);
  const int j = (int)(p - (int64_t)i * w);
  const int64_t base = n * 2 * hw;

  const float* vy_p = v + base;
  const float* vx_p = vy_p + hw;
  const float* my_p = m + base;
  const float* mx_p = my_p + hw;
  const float vy = __ldg(vy_p + p), vx = __ldg(vx_p + p);
  const float my = __ldg(my_p + p), mx = __ldg(mx_p + p);

  const float dvy_dy = ddy(vy_p, i, j, h, w), dvy_dx = ddx(vy_p, i, j, w);
  const float dvx_dy = ddy(vx_p, i, j, h, w), dvx_dx = ddx(vx_p, i, j, w);
  const float dmy_dy = ddy(my_p, i, j, h, w), dmy_dx = ddx(my_p, i, j, w);
  const float dmx_dy = ddy(mx_p, i, j, h, w), dmx_dx = ddx(mx_p, i, j, w);
  const float div = dvy_dy + dvx_dx;
  const float a_y = dvy_dy * my + dvx_dy * mx + dmy_dy * vy + dmy_dx * vx
                    + my * div;
  const float a_x = dvy_dx * my + dvx_dx * mx + dmx_dy * vy + dmx_dx * vx
                    + mx * div;
  m_out[base + p] = my - dt * a_y;
  m_out[base + hw + p] = mx - dt * a_x;

  // semi-Lagrangian map update: u'(x) = b(x) + u(x + b(x)), b = -dt v
  const float by = -dt * vy, bx = -dt * vx;
  const float cy = fminf(fmaxf((float)i + fminf(fmaxf(by, -r), r), 0.0f),
                         (float)(h - 1));
  const float cx = fminf(fmaxf((float)j + fminf(fmaxf(bx, -r), r), 0.0f),
                         (float)(w - 1));
  const float y0 = floorf(cy), x0 = floorf(cx);
  const float fy = cy - y0, fx = cx - x0;
  const int iy0 = (int)y0, ix0 = (int)x0;
  const int iy1 = min(iy0 + 1, h - 1), ix1 = min(ix0 + 1, w - 1);
  const float wy0 = 1.0f - fy, wx0 = 1.0f - fx;
  const float* uy_p = u + base;
  const float* ux_p = uy_p + hw;
  const int64_t o00 = (int64_t)iy0 * w + ix0, o01 = (int64_t)iy0 * w + ix1;
  const int64_t o10 = (int64_t)iy1 * w + ix0, o11 = (int64_t)iy1 * w + ix1;
  const float gy = wx0 * (wy0 * __ldg(uy_p + o00) + fy * __ldg(uy_p + o10))
                   + fx * (wy0 * __ldg(uy_p + o01) + fy * __ldg(uy_p + o11));
  const float gx = wx0 * (wy0 * __ldg(ux_p + o00) + fy * __ldg(ux_p + o10))
                   + fx * (wy0 * __ldg(ux_p + o01) + fy * __ldg(ux_p + o11));
  u_out[base + p] = by + gy;
  u_out[base + hw + p] = bx + gx;
}

}  // namespace

// v, m, u, m_out, u_out: (N, 2, H, W) f32, contiguous, on the current
// device; H, W >= 2. Returns cudaGetLastError().
extern "C" int epdiff_step_fwd(const float* v, const float* m, const float* u,
                               float* m_out, float* u_out, int n, int h,
                               int w, float dt, int radius,
                               cudaStream_t stream) {
  const int64_t n_pix = (int64_t)n * h * w;
  if (n_pix == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n_pix + threads - 1) / threads;
  epdiff_step_fwd_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      v, m, u, m_out, u_out, n_pix, h, w, dt, (float)(radius - 1));
  return (int)cudaGetLastError();
}
