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

// Loads of v. K2 takes v as an input and reads it through the read-only
// path (__ldg); K6 computes v into a scratch buffer earlier in the same
// kernel, where the non-coherent path is undefined, so it reads it with
// plain loads (VNC = false), as does K7's step_bwd_pixel.
template <bool VNC>
__device__ __forceinline__ float ldv(const float* p) {
  if constexpr (VNC) return __ldg(p);
  else return *p;
}

// d/dy of plane f at (i, j): central inside, one-sided on the first and
// last row (exactly cardiax/ops/shooting.py:_grad_hw).
template <bool NC>
__device__ __forceinline__ float ddy(const float* f, int i, int j, int h,
                                     int w) {
  if (i == 0) return ldv<NC>(f + w + j) - ldv<NC>(f + j);
  if (i == h - 1)
    return ldv<NC>(f + (int64_t)i * w + j)
           - ldv<NC>(f + (int64_t)(i - 1) * w + j);
  return 0.5f * (ldv<NC>(f + (int64_t)(i + 1) * w + j)
                 - ldv<NC>(f + (int64_t)(i - 1) * w + j));
}

template <bool NC>
__device__ __forceinline__ float ddx(const float* f, int i, int j, int w) {
  const float* row = f + (int64_t)i * w;
  if (j == 0) return ldv<NC>(row + 1) - ldv<NC>(row);
  if (j == w - 1) return ldv<NC>(row + j) - ldv<NC>(row + j - 1);
  return 0.5f * (ldv<NC>(row + j + 1) - ldv<NC>(row + j - 1));
}

// K2's body at pixel (i, j) = p of one item: v, m, u, m_out, u_out point at
// the item's (2, H, W) planes.
template <bool VNC>
__device__ __forceinline__ void step_fwd_pixel(
    const float* v, const float* __restrict__ m, const float* __restrict__ u,
    float* __restrict__ m_out, float* __restrict__ u_out, int64_t p, int i,
    int j, int h, int w, float dt, float r) {
  const int64_t hw = (int64_t)h * w;
  const float* vy_p = v;
  const float* vx_p = v + hw;
  const float* my_p = m;
  const float* mx_p = m + hw;
  const float vy = ldv<VNC>(vy_p + p), vx = ldv<VNC>(vx_p + p);
  const float my = __ldg(my_p + p), mx = __ldg(mx_p + p);

  const float dvy_dy = ddy<VNC>(vy_p, i, j, h, w);
  const float dvy_dx = ddx<VNC>(vy_p, i, j, w);
  const float dvx_dy = ddy<VNC>(vx_p, i, j, h, w);
  const float dvx_dx = ddx<VNC>(vx_p, i, j, w);
  const float dmy_dy = ddy<true>(my_p, i, j, h, w);
  const float dmy_dx = ddx<true>(my_p, i, j, w);
  const float dmx_dy = ddy<true>(mx_p, i, j, h, w);
  const float dmx_dx = ddx<true>(mx_p, i, j, w);
  const float div = dvy_dy + dvx_dx;
  const float a_y = dvy_dy * my + dvx_dy * mx + dmy_dy * vy + dmy_dx * vx
                    + my * div;
  const float a_x = dvy_dx * my + dvx_dx * mx + dmx_dy * vy + dmx_dx * vx
                    + mx * div;
  m_out[p] = my - dt * a_y;
  m_out[hw + p] = mx - dt * a_x;

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
  const float* uy_p = u;
  const float* ux_p = u + hw;
  const int64_t o00 = (int64_t)iy0 * w + ix0, o01 = (int64_t)iy0 * w + ix1;
  const int64_t o10 = (int64_t)iy1 * w + ix0, o11 = (int64_t)iy1 * w + ix1;
  const float gy = wx0 * (wy0 * __ldg(uy_p + o00) + fy * __ldg(uy_p + o10))
                   + fx * (wy0 * __ldg(uy_p + o01) + fy * __ldg(uy_p + o11));
  const float gx = wx0 * (wy0 * __ldg(ux_p + o00) + fy * __ldg(ux_p + o10))
                   + fx * (wy0 * __ldg(ux_p + o01) + fy * __ldg(ux_p + o11));
  u_out[p] = by + gy;
  u_out[hw + p] = bx + gx;
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
  step_fwd_pixel<true>(v + base, m + base, u + base, m_out + base,
                       u_out + base, p, i, j, h, w, dt, r);
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
// Here each output pixel GATHERS instead: pixel (i, j) sums, over the
// (2R+1)^2 source pixels (i - d, j - e) whose clamped taps can land on it,
// hat_y(i) * (gu' * hat_x(j)) with the source's own coordinates, in the
// sweep's order (e outer, d inner, both ascending). Where the clip puts both
// taps on one row or column, both hat terms add, as there. That gives the
// TPU kernel's sums, without atomics, the same on every run.
//
// Bound on the H100: bytes. Reads v, m, u, gm', gu' (10 planes) and writes
// g_v, g_m, g_u (6 planes); the function itself needs about 160 flops a
// pixel. A gather that recomputes each source's coordinates for each of
// the 25 pixels it might reach spends ~1,200-1,500 instructions a pixel and
// is bound by instruction throughput, not bytes (the per-pixel
// step_bwd_pixel below, which K3 ran before this design and K7's phase B
// still runs).
//
// Design (epdiff_step_bwd_tiled): a block of 256 threads owns a tile of
// 32 x 16 output pixels of one item, two rows a thread, the item in
// blockIdx.z (looping past 65,535 items), so no thread divides to find its
// pixel. It stages, with coalesced row loads clipped to the item's plane:
//   - over the tile +- R, each source's record, computed once: the rows and
//     columns its two taps land on as bit masks over the offsets
//     -(R-1)..R, its near and far y weights, and its gu' (2 channels) times
//     its near and far x weights; and u, which holds every tap of the
//     tile's own pixels;
//   - over the tile +- 1, v, m and the eight products p1..p8 of the ad*
//     adjoint's transposed stencils, each computed once, not by its 5
//     readers.
// The gather reads one mask word per (d, e) (d, e = -R can hold no tap)
// and a source's weights only where both masks hold the pixel, a few of
// the (2R)^2; the thread's two rows share each mask read. The weights are
// the values hat() forms, and the terms and their order are those of
// step_bwd_pixel, so the sums are the same; an output differs from the
// per-pixel kernel only where the compiler contracts an expression
// differently (g_v, by up to 2 ulp). R = 1 and 2 (the radii
// expmap_shooting passes) are compiled with unrolled loops. Any other R
// runs epdiff_step_bwd_chunked: the same tile, halo-1 planes and terms,
// with the sources staged a chunk at a time, so any R fits shared memory
// (R clipped to max(H, W), where the clamp at R - 1 and the clip act the
// same).
//
// What bounds it (PERF.md, from chip_smoke.py): latency and occupancy, not
// instruction throughput. R = 1 (9 pairs a pixel) takes little less than
// R = 2 (16), so the gather is a small part; the staging loads and the two
// barriers a block are the rest. The staging is unrolled so that its loads
// go out together, and the kernel is capped at 64 registers so that 4
// blocks fit an SM.

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
  const float vy = v[q];
  return {2.0f * a_y * my + a_x * mx, a_y * mx, a_y * vy, a_x * vy};
}

__device__ __forceinline__ DxArgs dx_args(const float* v, const float* m,
                                          const float* gm, int64_t hw,
                                          int64_t q, float dt) {
  const float a_y = -dt * __ldg(gm + q), a_x = -dt * __ldg(gm + hw + q);
  const float my = __ldg(m + q), mx = __ldg(m + hw + q);
  const float vx = v[hw + q];
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

// K7's phase B at pixel (i, j) = p of one item (K3's body before its tiled
// design): every pointer is at the item's (2, H, W) planes; v is read with
// plain loads (see ldv).
__device__ __forceinline__ void step_bwd_pixel(
    const float* vb, const float* __restrict__ mb, const float* __restrict__ ub,
    const float* __restrict__ gmb, const float* __restrict__ gub, float* gv,
    float* gm, float* __restrict__ gu, int64_t p, int i, int j, int h, int w,
    float dt, int R) {
  const float r = (float)(R - 1);
  const int64_t hw = (int64_t)h * w;
  const float vy = vb[p], vx = vb[hw + p];
  const float dvy_dy = ddy<false>(vb, i, j, h, w);
  const float dvy_dx = ddx<false>(vb, i, j, w);
  const float dvx_dy = ddy<false>(vb + hw, i, j, h, w);
  const float dvx_dx = ddx<false>(vb + hw, i, j, w);
  const float dmy_dy = ddy<true>(mb, i, j, h, w);
  const float dmy_dx = ddx<true>(mb, i, j, w);
  const float dmx_dy = ddy<true>(mb + hw, i, j, h, w);
  const float dmx_dx = ddx<true>(mb + hw, i, j, w);
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
        const Axis sy = axis_coord(is, -dt * vb[q], r, h);
        const Axis sxa = axis_coord(js, -dt * vb[hw + q], r, w);
        const float hy = hat(i, sy), hx = hat(j, sxa);
        be[0] += hy * (__ldg(gub + q) * hx);
        be[1] += hy * (__ldg(gub + hw + q) * hx);
      }
    }
    acc_gu[0] += be[0];
    acc_gu[1] += be[1];
  }
  gu[p] = acc_gu[0];
  gu[hw + p] = acc_gu[1];

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
  gv[p] = gv_y;
  gv[hw + p] = gv_x;
  gm[p] = gm_y;
  gm[hw + p] = gm_x;
}

// ---- K3, tiled -------------------------------------------------------------

constexpr int kBwdThreads = 256;     // 8 warps
constexpr int kBwdRows = 2;          // output rows a thread
constexpr int kBwdTileW = 32;
constexpr int kBwdTileH = 8 * kBwdRows;
constexpr int kBwdMinBlocks = 4;     // blocks an SM: at most 64 registers
constexpr int kStagingUnroll = 4;    // staging passes unrolled (R = 1, 2)
// the halo-1 planes: the tile +- 1
constexpr int kW1 = kBwdTileW + 2, kN1 = (kBwdTileH + 2) * kW1;
// the sources the runtime-R kernel stages at a time
constexpr int kChunkH = 16, kChunkW = 32;

// d/dy (or d/dx) at index k of n from the values at k - 1, k, k + 1: ddy's
// and ddx's expressions
__device__ __forceinline__ float d_stencil(float fm1, float f0, float fp1,
                                           int k, int n) {
  if (k == 0) return fp1 - f0;
  if (k == n - 1) return f0 - fm1;
  return 0.5f * (fp1 - fm1);
}

// hat() of a source's near tap: 1 - f, or 1 - f + f where the clip puts
// both taps on it (a0 == a1); its far tap weighs f
__device__ __forceinline__ float near_weight(Axis a) {
  return a.a1 == a.a0 ? (1.0f - a.f) + a.f : 1.0f - a.f;
}

// A staged source's gather weights: wy its near and far y weights, g its
// gu' (g0, g1) times its near and far x weights
__device__ __forceinline__ void source_weights(Axis ay, Axis ax, float g0,
                                               float g1, float2& wy,
                                               float4& g) {
  wy = make_float2(near_weight(ay), ay.f);
  const float wnx = near_weight(ax), wfx = ax.f;
  g = make_float4(g0 * wnx, g0 * wfx, g1 * wnx, g1 * wfx);
}

// A halo-1 pixel q's entries: v, m and the products p1..p8 of dy_args and
// dx_args (py: p1, p3, p5, p7; px: p2, p4, p6, p8)
__device__ __forceinline__ void ad_products(float vy, float vx,
                                            const float* mb, const float* gmb,
                                            int64_t hw, int64_t q, float dt,
                                            float2& vv, float2& mm,
                                            float4& py, float4& px) {
  const float a_y = -dt * __ldg(gmb + q), a_x = -dt * __ldg(gmb + hw + q);
  const float my = __ldg(mb + q), mx = __ldg(mb + hw + q);
  vv = make_float2(vy, vx);
  mm = make_float2(my, mx);
  py = make_float4(2.0f * a_y * my + a_x * mx, a_y * mx, a_y * vy, a_x * vy);
  px = make_float4(a_x * my, a_y * my + 2.0f * a_x * mx, a_y * vx, a_x * vx);
}

// K3's outputs at pixel (i, j) = p of the item at base, from its gathered
// g_u (gu0, gu1): the warp's d/d b with this pixel as a source, from its
// four taps of u (tap(y, x) is (u_y, u_x) at row y, column x), and the ad*
// adjoint from the halo-1 planes around their entry c1.
template <class TapU>
__device__ __forceinline__ void bwd_outputs(
    const float2* s_v, const float2* s_m, const float4* s_py,
    const float4* s_px, int c1, const float* gmb, const float* gub,
    float* __restrict__ gv, float* __restrict__ gm, float* __restrict__ gu,
    int64_t base, int64_t hw, int64_t p, int i, int j, int h, int w,
    float dt, float r, float gu0, float gu1, TapU tap) {
  const float2 vc = s_v[c1], mc = s_m[c1];
  const float2 vu = s_v[c1 - kW1], vd = s_v[c1 + kW1];
  const float2 vl = s_v[c1 - 1], vr = s_v[c1 + 1];
  const float2 mu = s_m[c1 - kW1], md = s_m[c1 + kW1];
  const float2 ml = s_m[c1 - 1], mr = s_m[c1 + 1];
  const float vy = vc.x, vx = vc.y;
  const float dvy_dy = d_stencil(vu.x, vc.x, vd.x, i, h);
  const float dvy_dx = d_stencil(vl.x, vc.x, vr.x, j, w);
  const float dvx_dy = d_stencil(vu.y, vc.y, vd.y, i, h);
  const float dvx_dx = d_stencil(vl.y, vc.y, vr.y, j, w);
  const float dmy_dy = d_stencil(mu.x, mc.x, md.x, i, h);
  const float dmy_dx = d_stencil(ml.x, mc.x, mr.x, j, w);
  const float dmx_dy = d_stencil(mu.y, mc.y, md.y, i, h);
  const float dmx_dx = d_stencil(ml.y, mc.y, mr.y, j, w);
  const float div = dvy_dy + dvx_dx;
  const float gmy = __ldg(gmb + p), gmx = __ldg(gmb + hw + p);
  const float guy = __ldg(gub + p), gux = __ldg(gub + hw + p);

  // warp adjoint, this pixel as a source: d/d b through warp(u, b)
  const float by = -dt * vy, bx = -dt * vx;
  const Axis ay = axis_coord(i, by, r, h), ax = axis_coord(j, bx, r, w);
  const float wmy = (fabsf(by) <= r && (float)i + by >= 0.0f
                     && (float)i + by <= (float)(h - 1)) ? 1.0f : 0.0f;
  const float wmx = (fabsf(bx) <= r && (float)j + bx >= 0.0f
                     && (float)j + bx <= (float)(w - 1)) ? 1.0f : 0.0f;
  const float sx = ax.a1 != ax.a0 ? 1.0f : 0.0f;
  const float wy0 = 1.0f - ay.f, wx0 = 1.0f - ax.f;
  const float2 u00 = tap(ay.a0, ax.a0), u10 = tap(ay.a1, ax.a0);
  const float2 u01 = tap(ay.a0, ax.a1), u11 = tap(ay.a1, ax.a1);
  const float gs[2] = {guy, gux};
  const float ta[2][2] = {{u00.x, u00.y}, {u01.x, u01.y}};
  const float tb[2][2] = {{u10.x, u10.y}, {u11.x, u11.y}};
  float acc_dy = 0.0f, acc_dx = 0.0f;
#pragma unroll
  for (int c = 0; c < 2; ++c) {            // column x0
    const float a = ta[0][c], b = tb[0][c];
    acc_dy += (wx0 * gs[c]) * (b - a);
    acc_dx += (-sx * gs[c]) * (wy0 * a + ay.f * b);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {            // column x1
    const float a = ta[1][c], b = tb[1][c];
    acc_dy += (ax.f * gs[c]) * (b - a);
    acc_dx += (sx * gs[c]) * (wy0 * a + ay.f * b);
  }
  const float g_by = guy + acc_dy * wmy;
  const float g_bx = gux + acc_dx * wmx;

  // ad* adjoint
  const float a_y = -dt * gmy, a_x = -dt * gmx;
  const float4 yc = s_py[c1], yu = s_py[c1 - kW1], yd = s_py[c1 + kW1];
  const float4 xc = s_px[c1], xl = s_px[c1 - 1], xr = s_px[c1 + 1];
  gv[base + p] = dT(yu.x, yc.x, yd.x, i, h) + dT(xl.x, xc.x, xr.x, j, w)
                 + a_y * dmy_dy + a_x * dmx_dy - dt * g_by;
  gv[base + hw + p] = dT(yu.y, yc.y, yd.y, i, h)
                      + dT(xl.y, xc.y, xr.y, j, w)
                      + a_y * dmy_dx + a_x * dmx_dx - dt * g_bx;
  gm[base + p] = gmy + a_y * (dvy_dy + div) + a_x * dvy_dx
                 + dT(yu.z, yc.z, yd.z, i, h) + dT(xl.z, xc.z, xr.z, j, w);
  gm[base + hw + p] = gmx + a_y * dvx_dy + a_x * (dvx_dx + div)
                      + dT(yu.w, yc.w, yd.w, i, h)
                      + dT(xl.w, xc.w, xr.w, j, w);
  gu[base + p] = gu0;
  gu[base + hw + p] = gu1;
}

// The shared memory of the compiled-R kernel: over the tile +- R, rec_g and
// rec_w (source_weights), su (u_y, u_x) and rec_m (the tap masks); over the
// tile +- 1, s_py, s_px, s_v and s_m (ad_products).
template <int R>
constexpr size_t bwd_smem_bytes() {
  return (size_t)(kBwdTileH + 2 * R) * (kBwdTileW + 2 * R) * 36
         + (size_t)kN1 * 48;
}

// K3 at a compiled radius R (1 or 2, the radii expmap_shooting passes).
template <int R>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
epdiff_step_bwd_tiled(const float* __restrict__ v,
                      const float* __restrict__ m,
                      const float* __restrict__ u,
                      const float* __restrict__ gmo,
                      const float* __restrict__ guo, float* __restrict__ gv,
                      float* __restrict__ gm, float* __restrict__ gu,
                      int n_items, int h, int w, float dt) {
  // a source's tap masks: bit o + R - 1 of the low half for a tap on row
  // is + o, o in [-(R - 1), R], of the high half for column js + o
  constexpr int kX = 16;
  constexpr int WR = kBwdTileW + 2 * R, NR = (kBwdTileH + 2 * R) * WR;
  extern __shared__ float4 smem4[];
  float4* rec_g = smem4;
  float4* s_py = rec_g + NR;
  float4* s_px = s_py + kN1;
  float2* rec_w = reinterpret_cast<float2*>(s_px + kN1);
  float2* su = rec_w + NR;
  float2* s_v = su + NR;
  float2* s_m = s_v + kN1;
  uint32_t* rec_m = reinterpret_cast<uint32_t*>(s_m + kN1);

  const float r = (float)(R - 1);
  const int64_t hw = (int64_t)h * w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx0 = blockIdx.x * kBwdTileW, ty0 = blockIdx.y * kBwdTileH;
  for (int n = blockIdx.z; n < n_items; n += gridDim.z) {
    const int64_t base = (int64_t)n * 2 * hw;
    const float* vb = v + base;
    const float* mb = m + base;
    const float* ub = u + base;
    const float* gmb = gmo + base;
    const float* gub = guo + base;

    // --- staging: one halo position a thread, row-major; the trip count
    // is a constant, so unrolled, the loads of every pass start before the
    // first pass's arithmetic -------------------------------------------
#pragma unroll kStagingUnroll
    for (int pass = 0; pass < (NR + kBwdThreads - 1) / kBwdThreads; ++pass) {
      const int k = tid + pass * kBwdThreads;
      if (k >= NR) break;
      const int hr = k / WR, hc = k - hr * WR;
      const int is = ty0 - R + hr, js = tx0 - R + hc;
      const bool ring1 = hr >= R - 1 && hr <= R + kBwdTileH && hc >= R - 1
                         && hc <= R + kBwdTileW;
      uint32_t mk = 0;                       // off the plane: never a tap
      float4 g = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float2 wy = make_float2(0.0f, 0.0f), uu = wy, vv = wy, mm = wy;
      float4 py = g, px = g;
      if (is >= 0 && is < h && js >= 0 && js < w) {
        const int64_t q = (int64_t)is * w + js;
        const float vy = __ldg(vb + q), vx = __ldg(vb + hw + q);
        const Axis ay = axis_coord(is, -dt * vy, r, h);
        const Axis ax = axis_coord(js, -dt * vx, r, w);
        mk = (1u << (ay.a0 - is + R - 1)) | (1u << (ay.a1 - is + R - 1))
             | (1u << (ax.a0 - js + R - 1 + kX))
             | (1u << (ax.a1 - js + R - 1 + kX));
        source_weights(ay, ax, __ldg(gub + q), __ldg(gub + hw + q), wy, g);
        uu = make_float2(__ldg(ub + q), __ldg(ub + hw + q));
        if (ring1) ad_products(vy, vx, mb, gmb, hw, q, dt, vv, mm, py, px);
      }
      rec_m[k] = mk;
      rec_g[k] = g;
      rec_w[k] = wy;
      su[k] = uu;
      if (ring1) {
        const int k1 = (hr - R + 1) * kW1 + (hc - R + 1);
        s_v[k1] = vv;
        s_m[k1] = mm;
        s_py[k1] = py;
        s_px[k1] = px;
      }
    }
    __syncthreads();

    const int j = tx0 + lane;
    const int lr0 = warp * kBwdRows;         // the thread's first tile row
    // --- the gather of g_u, all kBwdRows rows at once. A tap lies at
    // offset d, e in [-(R - 1), R] of its source (d, e = -R add only
    // zeros). The sources' rows are walked from the lowest up, so each of
    // the thread's rows sees d ascending, and each mask is read once. ----
    float acc[kBwdRows][2];
#pragma unroll
    for (int k = 0; k < kBwdRows; ++k) acc[k][0] = acc[k][1] = 0.0f;
#pragma unroll
    for (int e = 1 - R; e <= R; ++e) {
      float be[kBwdRows][2];
#pragma unroll
      for (int k = 0; k < kBwdRows; ++k) be[k][0] = be[k][1] = 0.0f;
      const int hc = lane - e + R;           // the sources' halo column
      const int xb = e + R - 1 + kX;         // their x bit for this pixel
#pragma unroll
      for (int t = 0; t < 2 * R + kBwdRows - 1; ++t) {
        const int hr = lr0 + kBwdRows + 2 * R - 2 - t;
        const int ks = hr * WR + hc;
        const uint32_t mk = rec_m[ks];
#pragma unroll
        for (int k = 0; k < kBwdRows; ++k) {
          const int d = t + k - kBwdRows - R + 2;  // row lr0 + k = hr - R + d
          if (d < 1 - R || d > R) continue;
          const int yb = d + R - 1;
          const uint32_t want = (1u << yb) | (1u << xb);
          if ((mk & want) != want) continue;
          // the far tap is the one whose bit below is set
          const bool far_y = yb > 0 && ((mk >> (yb - 1)) & 1u);
          const bool far_x = xb > kX && ((mk >> (xb - 1)) & 1u);
          const float2 wy = rec_w[ks];
          const float4 g = rec_g[ks];
          const float hy = far_y ? wy.y : wy.x;
          be[k][0] += hy * (far_x ? g.y : g.x);
          be[k][1] += hy * (far_x ? g.w : g.z);
        }
      }
#pragma unroll
      for (int k = 0; k < kBwdRows; ++k) {
        acc[k][0] += be[k][0];
        acc[k][1] += be[k][1];
      }
    }

    const auto tap = [&](int y, int x) {     // every tap lies in tile +- R
      return su[(y - ty0 + R) * WR + (x - tx0 + R)];
    };
#pragma unroll
    for (int k = 0; k < kBwdRows; ++k) {
      const int lr = lr0 + k, i = ty0 + lr;
      if (i >= h || j >= w) continue;
      bwd_outputs(s_v, s_m, s_py, s_px, (lr + 1) * kW1 + lane + 1, gmb, gub,
                  gv, gm, gu, base, hw, (int64_t)i * w + j, i, j, h, w, dt,
                  r, acc[k][0], acc[k][1], tap);
    }
    __syncthreads();                  // before the next item's staging
  }
}

// K3 at any other radius R >= 1, given at run time. The tile's sources
// (tile +- R, clipped to the plane) outgrow shared memory as R grows, so
// they are staged kChunkH x kChunkW at a time, chunks from the right and
// from the bottom, and each thread gathers from a chunk before the next
// replaces it: for each of its pixels e still ascends over the chunks'
// columns and d over each column's rows. A source's taps are kept as
// offsets, not bit masks, so any R fits, and a pixel's own taps of u are
// read from global memory.
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
epdiff_step_bwd_chunked(const float* __restrict__ v,
                        const float* __restrict__ m,
                        const float* __restrict__ u,
                        const float* __restrict__ gmo,
                        const float* __restrict__ guo, float* __restrict__ gv,
                        float* __restrict__ gm, float* __restrict__ gu,
                        int n_items, int h, int w, float dt, int R) {
  __shared__ float4 s_py[kN1], s_px[kN1], c_g[kChunkH * kChunkW];
  __shared__ float2 s_v[kN1], s_m[kN1], c_w[kChunkH * kChunkW];
  // the near taps' offsets, doubled, plus 1 where a far tap lies beyond
  __shared__ int2 c_t[kChunkH * kChunkW];

  const float r = (float)(R - 1);
  const int64_t hw = (int64_t)h * w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx0 = blockIdx.x * kBwdTileW, ty0 = blockIdx.y * kBwdTileH;
  const int j = tx0 + lane, i0 = ty0 + warp * kBwdRows;
  const int r_lo = max(ty0 - R, 0), r_hi = min(ty0 + kBwdTileH + R, h);
  const int c_lo = max(tx0 - R, 0), c_hi = min(tx0 + kBwdTileW + R, w);
  for (int n = blockIdx.z; n < n_items; n += gridDim.z) {
    const int64_t base = (int64_t)n * 2 * hw;
    const float* vb = v + base;
    const float* mb = m + base;
    const float* ub = u + base;
    const float* gmb = gmo + base;
    const float* gub = guo + base;

    for (int k = tid; k < kN1; k += kBwdThreads) {   // the halo-1 planes
      const int hr = k / kW1, hc = k - hr * kW1;
      const int is = ty0 - 1 + hr, js = tx0 - 1 + hc;
      float2 vv = make_float2(0.0f, 0.0f), mm = vv;
      float4 py = make_float4(0.0f, 0.0f, 0.0f, 0.0f), px = py;
      if (is >= 0 && is < h && js >= 0 && js < w) {
        const int64_t q = (int64_t)is * w + js;
        ad_products(__ldg(vb + q), __ldg(vb + hw + q), mb, gmb, hw, q, dt,
                    vv, mm, py, px);
      }
      s_v[k] = vv;
      s_m[k] = mm;
      s_py[k] = py;
      s_px[k] = px;
    }

    float acc[kBwdRows][2] = {};
    for (int cc = c_hi; cc > c_lo; cc -= kChunkW) {
      const int sc0 = max(cc - kChunkW, c_lo);
      for (int rc = r_hi; rc > r_lo; rc -= kChunkH) {
        const int sr0 = max(rc - kChunkH, r_lo);
        __syncthreads();              // the last chunk's gather is done
        for (int k = tid; k < kChunkH * kChunkW; k += kBwdThreads) {
          const int is = sr0 + k / kChunkW, js = sc0 + k % kChunkW;
          if (is >= rc || js >= cc) continue;
          const int64_t q = (int64_t)is * w + js;
          const Axis ay = axis_coord(is, -dt * __ldg(vb + q), r, h);
          const Axis ax = axis_coord(js, -dt * __ldg(vb + hw + q), r, w);
          c_t[k] = make_int2(2 * (ay.a0 - is) + (ay.a1 != ay.a0 ? 1 : 0),
                             2 * (ax.a0 - js) + (ax.a1 != ax.a0 ? 1 : 0));
          source_weights(ay, ax, __ldg(gub + q), __ldg(gub + hw + q), c_w[k],
                         c_g[k]);
        }
        __syncthreads();
        // the chunk's sources within reach of this thread's pixels (e, d in
        // [1 - R, R]): columns from the right (e ascending), rows from the
        // bottom (d ascending)
        const int x_hi = min(j + R - 1, cc - 1), x_lo = max(j - R, sc0);
        const int y_hi = min(i0 + kBwdRows + R - 2, rc - 1);
        const int y_lo = max(i0 - R, sr0);
        for (int js = x_hi; js >= x_lo; --js) {
          const int e = j - js;
          float be[kBwdRows][2] = {};
          for (int is = y_hi; is >= y_lo; --is) {
            const int ks = (is - sr0) * kChunkW + (js - sc0);
            const int2 t = c_t[ks];
            const int oy = t.x >> 1, ox = t.y >> 1;
            const bool far_x = e != ox;
            if (far_x && !((t.y & 1) && e == ox + 1)) continue;
#pragma unroll
            for (int k = 0; k < kBwdRows; ++k) {
              const int d = i0 + k - is;
              const bool far_y = d != oy;
              if (far_y && !((t.x & 1) && d == oy + 1)) continue;
              const float2 wy = c_w[ks];
              const float4 g = c_g[ks];
              const float hy = far_y ? wy.y : wy.x;
              be[k][0] += hy * (far_x ? g.y : g.x);
              be[k][1] += hy * (far_x ? g.w : g.z);
            }
          }
#pragma unroll
          for (int k = 0; k < kBwdRows; ++k) {
            acc[k][0] += be[k][0];
            acc[k][1] += be[k][1];
          }
        }
      }
    }

    const auto tap = [&](int y, int x) {
      const int64_t o = (int64_t)y * w + x;
      return make_float2(__ldg(ub + o), __ldg(ub + hw + o));
    };
#pragma unroll
    for (int k = 0; k < kBwdRows; ++k) {
      const int lr = warp * kBwdRows + k, i = ty0 + lr;
      if (i >= h || j >= w) continue;
      bwd_outputs(s_v, s_m, s_py, s_px, (lr + 1) * kW1 + lane + 1, gmb, gub,
                  gv, gm, gu, base, hw, (int64_t)i * w + j, i, j, h, w, dt,
                  r, acc[k][0], acc[k][1], tap);
    }
    __syncthreads();                  // before the next item's staging
  }
}

dim3 bwd_grid(int n, int h, int w) {
  return dim3((unsigned)((w + kBwdTileW - 1) / kBwdTileW),
              (unsigned)((h + kBwdTileH - 1) / kBwdTileH),
              (unsigned)(n < 65535 ? n : 65535));
}

template <int R>
cudaError_t launch_bwd_tiled(const float* v, const float* m, const float* u,
                             const float* gmo, const float* guo, float* gv,
                             float* gm, float* gu, int n, int h, int w,
                             float dt, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<R>();
  auto kernel = epdiff_step_bwd_tiled<R>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<bwd_grid(n, h, w), kBwdThreads, smem, stream>>>(
      v, m, u, gmo, guo, gv, gm, gu, n, h, w, dt);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K6 and K7: the step with the fluid-metric solve inside the kernel.
//
// K6 replaces cardiax/ops/epdiff_pallas.py:_fwd_solve_kernel (launched
// through epdiff_step_solve), K7 _bwd_solve_kernel (_step_solve_bwd). Per
// item (2, H, W), with the solve of fluid_metric.solve_mm_operands,
//
//   v = K m = Ty^T [ (Ty m Tx^T) * W ] Tx          (per channel),
//
// K6 computes (m, u) -> (m', u') as K2 does on that v, and K7 computes
// (m, u, gm', gu') -> (g_m + K g_v, g_u) from K3's (g_v, g_m, g_u) on the
// recomputed v (K is self-adjoint). No v leaves the kernel and none is saved
// for the backward, as on the TPU.
//
// Bound on the H100: f32 operations. The solve is four (S x S)(S x S)
// products per channel, 4 H W (H + W) flops: K6 solves 2 planes, K7 4, so
// at the flagship's 64^2 items the solve is ~96% of the arithmetic and
// about 35 flops for every byte each kernel must move.
//
// Design (simple and right first): one block of 256 threads per item, so
// that __syncthreads() orders every phase of the item. Phase A runs the
// four products per channel as a shared-memory tiled f32 GEMM (64 x 64
// output tiles, 16-deep k tiles, a 4 x 4 register tile a thread, fmaf on
// the CUDA cores: no tensor cores, hence no TF32, and no library GEMM).
// The intermediates and v live in a per-item global scratch buffer that
// only the item's own block writes and reads (L1/L2-resident at these
// sizes; a 128^2 item does not fit shared memory), read with plain loads,
// never __ldg. Phase B runs K2's (K6) or K3's (K7) per-pixel body over the
// item's pixels, reading v from the scratch; K7 writes g_v there and phase C
// applies the same four products to it and adds the result to g_m.

constexpr int kThreads = 256;
constexpr int kTile = 64;     // output tile side
constexpr int kDepth = 16;    // k tile depth
constexpr int kPad = kTile + 1;

// C (M x N, row-major) = A (M x K) B (K x N) on one block, where element
// (i, k) of A is A[i * sai + k * sak] and (k, j) of B is B[k * sbk + j * sbj]
// (so a transpose is a swap of strides). With wgt, C = (A B) * wgt
// elementwise; with accumulate, C += A B. The sums run over k in ascending
// order, one fmaf each. Every thread of the block must call it; it begins
// with a __syncthreads(), so the products' inputs written earlier by the
// block are visible, and ends with one, so its output is.
__device__ void block_mm(const float* A, int sai, int sak, const float* B,
                         int sbk, int sbj, const float* wgt, float* C,
                         bool accumulate, int M, int N, int K, float* smA,
                         float* smB) {
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  for (int m0 = 0; m0 < M; m0 += kTile) {
    for (int n0 = 0; n0 < N; n0 += kTile) {
      float acc[4][4];
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
      for (int k0 = 0; k0 < K; k0 += kDepth) {
        __syncthreads();
        for (int l = 0; l < kDepth * kTile / kThreads; ++l) {
          const int e = tid + kThreads * l;
          // the index that is contiguous in memory varies fastest
          int k = sak == 1 ? e % kDepth : e / kTile;
          const int mi = sak == 1 ? e / kDepth : e % kTile;
          int gk = k0 + k, gi = m0 + mi;
          smA[k * kPad + mi] = (gi < M && gk < K)
              ? A[(int64_t)gi * sai + (int64_t)gk * sak] : 0.0f;
          k = sbk == 1 ? e % kDepth : e / kTile;
          const int nj = sbk == 1 ? e / kDepth : e % kTile;
          gk = k0 + k;
          const int gj = n0 + nj;
          smB[k * kPad + nj] = (gj < N && gk < K)
              ? B[(int64_t)gk * sbk + (int64_t)gj * sbj] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kDepth; ++kk) {
          float av[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) av[a] = smA[kk * kPad + tr + 16 * a];
#pragma unroll
          for (int b = 0; b < 4; ++b) bv[b] = smB[kk * kPad + tc + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
        }
      }
      for (int a = 0; a < 4; ++a) {
        const int gi = m0 + tr + 16 * a;
        if (gi >= M) continue;
        for (int b = 0; b < 4; ++b) {
          const int gj = n0 + tc + 16 * b;
          if (gj >= N) continue;
          const int64_t o = (int64_t)gi * N + gj;
          float val = acc[a][b];
          if (wgt != nullptr) val *= __ldg(wgt + o);
          C[o] = accumulate ? C[o] + val : val;
        }
      }
    }
  }
  __syncthreads();
}

// out = Ty^T [ (Ty x Tx^T) * W ] Tx on one (h, w) plane, in the order of
// epdiff_pallas.py:_solve_mm; t1, t2 are (h, w) scratch planes (t2 may be
// out when out is not accumulated into). With accumulate, out += K x.
__device__ void block_solve(const float* x, const float* ty, const float* tx,
                            const float* wgt, float* out, bool accumulate,
                            float* t1, float* t2, int h, int w, float* smA,
                            float* smB) {
  block_mm(ty, h, 1, x, w, 1, nullptr, t1, false, h, w, h, smA, smB);
  block_mm(t1, w, 1, tx, 1, w, wgt, t2, false, h, w, w, smA, smB);
  block_mm(ty, 1, h, t2, w, 1, nullptr, t1, false, h, w, h, smA, smB);
  block_mm(t1, w, 1, tx, w, 1, nullptr, out, accumulate, h, w, w, smA, smB);
}

// scratch: 3 planes an item, (v_y, v_x, t)
__global__ void __launch_bounds__(kThreads) epdiff_step_solve_fwd_kernel(
    const float* __restrict__ m, const float* __restrict__ u,
    const float* __restrict__ ty, const float* __restrict__ tx,
    const float* __restrict__ wgt, float* __restrict__ m_out,
    float* __restrict__ u_out, float* scratch, int h, int w, float dt,
    float r) {
  __shared__ float smA[kDepth * kPad], smB[kDepth * kPad];
  const int64_t hw = (int64_t)h * w;
  const int64_t base = (int64_t)blockIdx.x * 2 * hw;
  float* v = scratch + (int64_t)blockIdx.x * 3 * hw;
  float* t = v + 2 * hw;
  for (int c = 0; c < 2; ++c)         // phase A: v = K m
    block_solve(m + base + c * hw, ty, tx, wgt, v + c * hw, false, t,
                v + c * hw, h, w, smA, smB);
  for (int64_t p = threadIdx.x; p < hw; p += kThreads) {   // phase B
    const int i = (int)(p / w);
    const int j = (int)(p - (int64_t)i * w);
    step_fwd_pixel<false>(v, m + base, u + base, m_out + base, u_out + base,
                          p, i, j, h, w, dt, r);
  }
}

// scratch: 5 planes an item, (v_y, v_x, t, g_v y, g_v x)
__global__ void __launch_bounds__(kThreads) epdiff_step_solve_bwd_kernel(
    const float* __restrict__ m, const float* __restrict__ u,
    const float* __restrict__ ty, const float* __restrict__ tx,
    const float* __restrict__ wgt, const float* __restrict__ gmo,
    const float* __restrict__ guo, float* gm, float* __restrict__ gu,
    float* scratch, int h, int w, float dt, int R) {
  __shared__ float smA[kDepth * kPad], smB[kDepth * kPad];
  const int64_t hw = (int64_t)h * w;
  const int64_t base = (int64_t)blockIdx.x * 2 * hw;
  float* v = scratch + (int64_t)blockIdx.x * 5 * hw;
  float* t = v + 2 * hw;
  float* gv = v + 3 * hw;
  for (int c = 0; c < 2; ++c)         // phase A: v = K m, recomputed
    block_solve(m + base + c * hw, ty, tx, wgt, v + c * hw, false, t,
                v + c * hw, h, w, smA, smB);
  for (int64_t p = threadIdx.x; p < hw; p += kThreads) {   // phase B
    const int i = (int)(p / w);
    const int j = (int)(p - (int64_t)i * w);
    step_bwd_pixel(v, m + base, u + base, gmo + base, guo + base, gv,
                          gm + base, gu + base, p, i, j, h, w, dt, R);
  }
  // phase C: g_m += K g_v; v is dead, so its plane serves as scratch
  for (int c = 0; c < 2; ++c)
    block_solve(gv + c * hw, ty, tx, wgt, gm + base + c * hw, true, t, v, h,
                w, smA, smB);
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
// (N, 2, H, W) f32, contiguous, on the current device; H, W >= 4; radius
// >= 1 (cudaErrorInvalidValue otherwise). Returns cudaGetLastError().
extern "C" int epdiff_step_bwd(const float* v, const float* m, const float* u,
                               const float* gm_out, const float* gu_out,
                               float* gv, float* gm, float* gu, int n, int h,
                               int w, float dt, int radius,
                               cudaStream_t stream) {
  if ((int64_t)n * h * w == 0) return (int)cudaSuccess;
  if (radius < 1) return (int)cudaErrorInvalidValue;
  if (radius == 1)
    return (int)launch_bwd_tiled<1>(v, m, u, gm_out, gu_out, gv, gm, gu, n, h,
                                    w, dt, stream);
  if (radius == 2)
    return (int)launch_bwd_tiled<2>(v, m, u, gm_out, gu_out, gv, gm, gu, n, h,
                                    w, dt, stream);
  // beyond max(H, W) the clamp at radius - 1 bites nowhere the clip does not
  const int hw_max = h > w ? h : w;
  epdiff_step_bwd_chunked<<<bwd_grid(n, h, w), kBwdThreads, 0, stream>>>(
      v, m, u, gm_out, gu_out, gv, gm, gu, n, h, w, dt,
      radius < hw_max ? radius : hw_max);
  return (int)cudaGetLastError();
}

// m, u, m_out, u_out: (N, 2, H, W); ty (H, H), tx (W, W), wgt (H, W); the
// scratch holds N * 3 * H * W floats. All f32, contiguous, on the current
// device; H, W >= 2. Returns cudaGetLastError().
extern "C" int epdiff_step_solve_fwd(const float* m, const float* u,
                                     const float* ty, const float* tx,
                                     const float* wgt, float* m_out,
                                     float* u_out, float* scratch, int n,
                                     int h, int w, float dt, int radius,
                                     cudaStream_t stream) {
  if (n == 0) return (int)cudaSuccess;
  epdiff_step_solve_fwd_kernel<<<n, kThreads, 0, stream>>>(
      m, u, ty, tx, wgt, m_out, u_out, scratch, h, w, dt,
      (float)(radius - 1));
  return (int)cudaGetLastError();
}

// m, u, gm_out, gu_out (the cotangents of m', u') -> gm, gu: (N, 2, H, W);
// operands as above; the scratch holds N * 5 * H * W floats. All f32,
// contiguous, on the current device; H, W >= 4. Returns cudaGetLastError().
extern "C" int epdiff_step_solve_bwd(const float* m, const float* u,
                                     const float* ty, const float* tx,
                                     const float* wgt, const float* gm_out,
                                     const float* gu_out, float* gm,
                                     float* gu, float* scratch, int n, int h,
                                     int w, float dt, int radius,
                                     cudaStream_t stream) {
  if (n == 0) return (int)cudaSuccess;
  epdiff_step_solve_bwd_kernel<<<n, kThreads, 0, stream>>>(
      m, u, ty, tx, wgt, gm_out, gu_out, gm, gu, scratch, h, w, dt, radius);
  return (int)cudaGetLastError();
}
