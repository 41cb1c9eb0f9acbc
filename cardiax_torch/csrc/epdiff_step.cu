// K2: one forward Euler step of EPDiff with the semi-Lagrangian map update;
// K3 (below): its backward.
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

// ---------------------------------------------------------------------------
// K3: the step's hand-derived VJP.
//
// Replaces cardiax/ops/epdiff_pallas.py:_bwd_kernel (launched through
// _step_bwd): (v, m, u, gm', gu') -> (g_v, g_m, g_u). With b = -dt v and
// (a_y, a_x) = -dt gm' (epdiff_pallas.py:22-27, :205-255):
//
//   g_u[c]  = warp(., b)^T gu'[c]                     (the warp's adjoint)
//   g_b     = gu' + mask * sum_c gu'[c] d warp(u[c], b) / d coordinate
//   g_vy = DyT(2 a_y my + a_x mx) + DxT(a_x my) + a_y dmy_dy + a_x dmx_dy
//          - dt g_by
//   g_vx = DyT(a_y mx) + DxT(a_y my + 2 a_x mx) + a_y dmy_dx + a_x dmx_dx
//          - dt g_bx
//   g_my = gm'_y + a_y (dvy_dy + div) + a_x dvy_dx + DyT(a_y vy) + DxT(a_y vx)
//   g_mx = gm'_x + a_y dvx_dy + a_x (dvx_dx + div) + DyT(a_x vy) + DxT(a_x vx)
//
// DyT/DxT are the exact transposes of the one-sided central difference
// (epdiff_pallas.py:_dyT/_dxT; exact only for H, W >= 4, which the wrapper
// enforces). The mask is _coords_local's my/mx, tested on the unclamped b.
//
// The TPU kernel forms g_u by scattering through a band of rolled planes.
// Here each thread GATHERS instead: output pixel (i, j) sums, over the
// (2R+1)^2 source pixels (i - d, j - e) whose clamped taps can land on it,
// hat_y(i) * (gu' * hat_x(j)) with the source's own coordinates recomputed,
// in the sweep's order (e outer, d inner, both ascending). Where the clip
// puts both taps on one row or column, both hat terms add, as there. That
// gives the TPU kernel's sums, without atomics, the same on every run.
//
// Bound on the H100: bytes. Reads v, m, u, gm', gu' (10 planes) and writes
// g_v, g_m, g_u (6 planes); the function itself needs about 160 flops a
// pixel. The gather recomputes each source's coordinates for every pixel it
// might reach (~25 x 35 flops a pixel), which still fits in about the time
// the bytes take at the f32 rate. One thread per pixel; the neighbour and
// source reads of adjacent threads overlap and are served by L1/L2.

// The transpose of the one-sided central difference along one axis at
// index k of n: gm1 = g(k-1), g0 = g(k), gp1 = g(k+1) (unused ones may be
// anything). The expressions are epdiff_pallas.py:_dyT's, term for term.
__device__ __forceinline__ float dT(float gm1, float g0, float gp1, int k,
                                    int n) {
  const float base = 0.5f * (gm1 - gp1);
  if (k == n - 1) return 0.5f * gm1 + g0;
  if (k == n - 2) return base - 0.5f * gp1;
  if (k == 1) return base + 0.5f * gm1;
  if (k == 0) return -g0 - 0.5f * gp1;
  return base;
}

// The four products whose DyT the VJP needs, at pixel q of one item.
struct DyArgs { float p1, p3, p5, p7; };
// The four products whose DxT the VJP needs.
struct DxArgs { float p2, p4, p6, p8; };

__device__ __forceinline__ DyArgs dy_args(const float* v, const float* m,
                                          const float* gm, int64_t hw,
                                          int64_t q, float dt) {
  const float a_y = -dt * __ldg(gm + q), a_x = -dt * __ldg(gm + hw + q);
  const float my = __ldg(m + q), mx = __ldg(m + hw + q);
  const float vy = __ldg(v + q);
  return {2.0f * a_y * my + a_x * mx, a_y * mx, a_y * vy, a_x * vy};
}

__device__ __forceinline__ DxArgs dx_args(const float* v, const float* m,
                                          const float* gm, int64_t hw,
                                          int64_t q, float dt) {
  const float a_y = -dt * __ldg(gm + q), a_x = -dt * __ldg(gm + hw + q);
  const float my = __ldg(m + q), mx = __ldg(m + hw + q);
  const float vx = __ldg(v + hw + q);
  return {a_x * my, a_y * my + 2.0f * a_x * mx, a_y * vx, a_x * vx};
}

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

__global__ void epdiff_step_bwd_kernel(const float* __restrict__ v,
                                       const float* __restrict__ m,
                                       const float* __restrict__ u,
                                       const float* __restrict__ gmo,
                                       const float* __restrict__ guo,
                                       float* __restrict__ gv,
                                       float* __restrict__ gm,
                                       float* __restrict__ gu,
                                       int64_t n_pix, int h, int w, float dt,
                                       int R) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_pix) return;
  const float r = (float)(R - 1);
  const int64_t hw = (int64_t)h * w;
  const int64_t n = idx / hw;
  const int64_t p = idx - n * hw;
  const int i = (int)(p / w);
  const int j = (int)(p - (int64_t)i * w);
  const int64_t base = n * 2 * hw;
  const float* vb = v + base;
  const float* mb = m + base;
  const float* ub = u + base;
  const float* gmb = gmo + base;
  const float* gub = guo + base;

  const float vy = __ldg(vb + p), vx = __ldg(vb + hw + p);
  const float dvy_dy = ddy(vb, i, j, h, w), dvy_dx = ddx(vb, i, j, w);
  const float dvx_dy = ddy(vb + hw, i, j, h, w), dvx_dx = ddx(vb + hw, i, j, w);
  const float dmy_dy = ddy(mb, i, j, h, w), dmy_dx = ddx(mb, i, j, w);
  const float dmx_dy = ddy(mb + hw, i, j, h, w), dmx_dx = ddx(mb + hw, i, j, w);
  const float div = dvy_dy + dvx_dx;
  const float gmy = __ldg(gmb + p), gmx = __ldg(gmb + hw + p);
  const float guy = __ldg(gub + p), gux = __ldg(gub + hw + p);

  // --- warp adjoint, this pixel as a source: d/d b through warp(u, b) -----
  const float by = -dt * vy, bx = -dt * vx;
  const Axis ay = axis_coord(i, by, r, h), ax = axis_coord(j, bx, r, w);
  const float wmy = (fabsf(by) <= r && (float)i + by >= 0.0f
                     && (float)i + by <= (float)(h - 1)) ? 1.0f : 0.0f;
  const float wmx = (fabsf(bx) <= r && (float)j + bx >= 0.0f
                     && (float)j + bx <= (float)(w - 1)) ? 1.0f : 0.0f;
  const float sx = ax.a1 != ax.a0 ? 1.0f : 0.0f;
  const float wy0 = 1.0f - ay.f, wx0 = 1.0f - ax.f;
  const int64_t o00 = (int64_t)ay.a0 * w + ax.a0;
  const int64_t o01 = (int64_t)ay.a0 * w + ax.a1;
  const int64_t o10 = (int64_t)ay.a1 * w + ax.a0;
  const int64_t o11 = (int64_t)ay.a1 * w + ax.a1;
  const float gs[2] = {guy, gux};
  float acc_dy = 0.0f, acc_dx = 0.0f;
  for (int c = 0; c < 2; ++c) {               // column x0
    const float a = __ldg(ub + c * hw + o00), b = __ldg(ub + c * hw + o10);
    acc_dy += (wx0 * gs[c]) * (b - a);
    acc_dx += (-sx * gs[c]) * (wy0 * a + ay.f * b);
  }
  for (int c = 0; c < 2; ++c) {               // column x1
    const float a = __ldg(ub + c * hw + o01), b = __ldg(ub + c * hw + o11);
    acc_dy += (ax.f * gs[c]) * (b - a);
    acc_dx += (sx * gs[c]) * (wy0 * a + ay.f * b);
  }
  const float g_by = guy + acc_dy * wmy;
  const float g_bx = gux + acc_dx * wmx;

  // --- warp adjoint, this pixel as a tap: g_u by gathering its sources ----
  float acc_gu[2] = {0.0f, 0.0f};
  for (int e = -R; e <= R; ++e) {
    const int js = j - e;
    float be[2] = {0.0f, 0.0f};
    if (js >= 0 && js < w) {
      for (int d = -R; d <= R; ++d) {
        const int is = i - d;
        if (is < 0 || is >= h) continue;
        const int64_t q = (int64_t)is * w + js;
        const Axis sy = axis_coord(is, -dt * __ldg(vb + q), r, h);
        const Axis sxa = axis_coord(js, -dt * __ldg(vb + hw + q), r, w);
        const float hy = hat(i, sy), hx = hat(j, sxa);
        be[0] += hy * (__ldg(gub + q) * hx);
        be[1] += hy * (__ldg(gub + hw + q) * hx);
      }
    }
    acc_gu[0] += be[0];
    acc_gu[1] += be[1];
  }
  gu[base + p] = acc_gu[0];
  gu[base + hw + p] = acc_gu[1];

  // --- ad* adjoint ---------------------------------------------------------
  const float a_y = -dt * gmy, a_x = -dt * gmx;
  const DyArgs yc = dy_args(vb, mb, gmb, hw, p, dt);
  const DyArgs yu = i > 0 ? dy_args(vb, mb, gmb, hw, p - w, dt) : yc;
  const DyArgs yd = i < h - 1 ? dy_args(vb, mb, gmb, hw, p + w, dt) : yc;
  const DxArgs xc = dx_args(vb, mb, gmb, hw, p, dt);
  const DxArgs xl = j > 0 ? dx_args(vb, mb, gmb, hw, p - 1, dt) : xc;
  const DxArgs xr = j < w - 1 ? dx_args(vb, mb, gmb, hw, p + 1, dt) : xc;
  const float gv_y = dT(yu.p1, yc.p1, yd.p1, i, h) + dT(xl.p2, xc.p2, xr.p2, j, w)
                     + a_y * dmy_dy + a_x * dmx_dy - dt * g_by;
  const float gv_x = dT(yu.p3, yc.p3, yd.p3, i, h) + dT(xl.p4, xc.p4, xr.p4, j, w)
                     + a_y * dmy_dx + a_x * dmx_dx - dt * g_bx;
  const float gm_y = gmy + a_y * (dvy_dy + div) + a_x * dvy_dx
                     + dT(yu.p5, yc.p5, yd.p5, i, h) + dT(xl.p6, xc.p6, xr.p6, j, w);
  const float gm_x = gmx + a_y * dvx_dy + a_x * (dvx_dx + div)
                     + dT(yu.p7, yc.p7, yd.p7, i, h) + dT(xl.p8, xc.p8, xr.p8, j, w);
  gv[base + p] = gv_y;
  gv[base + hw + p] = gv_x;
  gm[base + p] = gm_y;
  gm[base + hw + p] = gm_x;
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

// v, m, u, gm_out, gu_out (the cotangents of m', u') -> gv, gm, gu: all
// (N, 2, H, W) f32, contiguous, on the current device; H, W >= 4.
// Returns cudaGetLastError().
extern "C" int epdiff_step_bwd(const float* v, const float* m, const float* u,
                               const float* gm_out, const float* gu_out,
                               float* gv, float* gm, float* gu, int n, int h,
                               int w, float dt, int radius,
                               cudaStream_t stream) {
  const int64_t n_pix = (int64_t)n * h * w;
  if (n_pix == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n_pix + threads - 1) / threads;
  epdiff_step_bwd_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      v, m, u, gm_out, gu_out, gv, gm, gu, n_pix, h, w, dt, radius);
  return (int)cudaGetLastError();
}
