// K2: one forward Euler step of EPDiff with the semi-Lagrangian map update;
// K3 (below): its backward; K6/K7 (last): both with the fluid-metric solve
// inside the kernel.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// One item's (2, H, W) planes in device memory, read through the read-only
// path: f(c, i, j) is channel c at row i, column j.
struct Planes {
  const float* p;
  int64_t hw;
  int w;
  __device__ __forceinline__ float operator()(int c, int i, int j) const {
    return __ldg(p + c * hw + (int64_t)i * w + j);
  }
};

// d/dy of channel c of f at (i, j): central inside, one-sided on the first
// and last row (exactly cardiax/ops/shooting.py:_grad_hw).
template <class F>
__device__ __forceinline__ float ddy(F f, int c, int i, int j, int h) {
  if (i == 0) return f(c, 1, j) - f(c, 0, j);
  if (i == h - 1) return f(c, i, j) - f(c, i - 1, j);
  return 0.5f * (f(c, i + 1, j) - f(c, i - 1, j));
}

template <class F>
__device__ __forceinline__ float ddx(F f, int c, int i, int j, int w) {
  if (j == 0) return f(c, i, 1) - f(c, i, 0);
  if (j == w - 1) return f(c, i, j) - f(c, i, j - 1);
  return 0.5f * (f(c, i, j + 1) - f(c, i, j - 1));
}

// K2's body at pixel (i, j) = p of one item: v(c, i, j) reads v (K2: device
// memory; K6: its cluster's shared memory), m the item's m; u, m_out, u_out
// point at the item's (2, H, W) planes.
template <class V>
__device__ __forceinline__ void step_fwd_pixel(
    V v, Planes m, const float* __restrict__ u, float* __restrict__ m_out,
    float* __restrict__ u_out, int64_t p, int i, int j, int h, int w,
    float dt, float r) {
  const int64_t hw = (int64_t)h * w;
  const float vy = v(0, i, j), vx = v(1, i, j);
  const float my = m(0, i, j), mx = m(1, i, j);

  const float dvy_dy = ddy(v, 0, i, j, h);
  const float dvy_dx = ddx(v, 0, i, j, w);
  const float dvx_dy = ddy(v, 1, i, j, h);
  const float dvx_dx = ddx(v, 1, i, j, w);
  const float dmy_dy = ddy(m, 0, i, j, h);
  const float dmy_dx = ddx(m, 0, i, j, w);
  const float dmx_dy = ddy(m, 1, i, j, h);
  const float dmx_dx = ddx(m, 1, i, j, w);
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
  step_fwd_pixel(Planes{v + base, hw, w}, Planes{m + base, hw, w}, u + base,
                 m_out + base, u_out + base, p, i, j, h, w, dt, r);
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
// is bound by instruction throughput, not bytes (K3's per-pixel body before
// this design).
//
// Design (bwd_tile, in epdiff_step_bwd_tiled): a block of 256 threads owns a
// tile of 32 x 16 output pixels of one item, two rows a thread, the item in
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
// the values of the hat weights, and the terms and their order are those of
// the per-pixel sums, so the sums are the same. R = 1 and 2 (the radii
// expmap_shooting passes) are compiled with unrolled loops. Any other R
// runs bwd_tile_chunked (in epdiff_step_bwd_chunked): the same tile, halo-1
// planes and terms, with the sources staged a chunk at a time, so any R
// fits shared memory (R clipped to max(H, W), where the clamp at R - 1 and
// the clip act the same). K7 runs the same two tile bodies on the rows of
// its item that a block holds, with v read from its cluster's shared memory
// (the V accessor) and g_v, g_m written there (the Out functor).
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

// The hat weight of a source's near tap: 1 - f, or 1 - f + f where the clip
// puts both taps on it (a0 == a1; warp_pallas.py:_hat adds both terms);
// its far tap weighs f
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

// A halo-1 pixel q's entries: v, m and the eight products p1..p8 whose
// transposed stencils the VJP needs (py: p1, p3, p5, p7 under DyT; px: p2,
// p4, p6, p8 under DxT)
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

// Where K3 puts its outputs: the item's g_v, g_m, g_u planes in device
// memory, at pixel p.
struct GlobalGrads {
  float* gv;
  float* gm;
  float* gu;
  int64_t hw;
  __device__ __forceinline__ void operator()(int64_t p, int, int, float gvy,
                                             float gvx, float gmy, float gmx,
                                             float gu0, float gu1) const {
    gv[p] = gvy;
    gv[hw + p] = gvx;
    gm[p] = gmy;
    gm[hw + p] = gmx;
    gu[p] = gu0;
    gu[hw + p] = gu1;
  }
};

// K3's outputs at pixel (i, j) = p of one item, from its gathered g_u (gu0,
// gu1): the warp's d/d b with this pixel as a source, from its four taps of
// u (tap(y, x) is (u_y, u_x) at row y, column x), and the ad* adjoint from
// the halo-1 planes around their entry c1; out(p, i, j, g_v y, g_v x, g_m
// y, g_m x, g_u y, g_u x) stores them.
template <class TapU, class Out>
__device__ __forceinline__ void bwd_outputs(
    const float2* s_v, const float2* s_m, const float4* s_py,
    const float4* s_px, int c1, const float* gmb, const float* gub, Out out,
    int64_t hw, int64_t p, int i, int j, int h, int w, float dt, float r,
    float gu0, float gu1, TapU tap) {
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
  out(p, i, j,
      dT(yu.x, yc.x, yd.x, i, h) + dT(xl.x, xc.x, xr.x, j, w)
          + a_y * dmy_dy + a_x * dmx_dy - dt * g_by,
      dT(yu.y, yc.y, yd.y, i, h) + dT(xl.y, xc.y, xr.y, j, w)
          + a_y * dmy_dx + a_x * dmx_dx - dt * g_bx,
      gmy + a_y * (dvy_dy + div) + a_x * dvy_dx
          + dT(yu.z, yc.z, yd.z, i, h) + dT(xl.z, xc.z, xr.z, j, w),
      gmx + a_y * dvx_dy + a_x * (dvx_dx + div)
          + dT(yu.w, yc.w, yd.w, i, h) + dT(xl.w, xc.w, xr.w, j, w),
      gu0, gu1);
}

// The shared memory of the compiled-R tile: over the tile +- R, rec_g and
// rec_w (source_weights), su (u_y, u_x) and rec_m (the tap masks); over the
// tile +- 1, s_py, s_px, s_v and s_m (ad_products).
template <int R>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return (size_t)(kBwdTileH + 2 * R) * (kBwdTileW + 2 * R) * 36
         + (size_t)kN1 * 48;
}

// K3's tile at a compiled radius R (1 or 2, the radii expmap_shooting
// passes): the 32 x 16 output pixels from (ty0, tx0) of one item, whose v
// is vat(c, i, j) and whose m, u, gm', gu' planes are at mb, ub, gmb, gub;
// out stores the outputs. Every thread of the block calls it; smem4 holds
// bwd_smem_bytes<R>(). It ends with a barrier, so the next tile may stage.
template <int R, class V, class Out>
__device__ __forceinline__ void bwd_tile(float4* smem4, V vat,
                                         const float* mb, const float* ub,
                                         const float* gmb, const float* gub,
                                         Out out, int tx0, int ty0, int h,
                                         int w, float dt) {
  // a source's tap masks: bit o + R - 1 of the low half for a tap on row
  // is + o, o in [-(R - 1), R], of the high half for column js + o
  constexpr int kX = 16;
  constexpr int WR = kBwdTileW + 2 * R, NR = (kBwdTileH + 2 * R) * WR;
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

  // --- staging: one halo position a thread, row-major; the trip count is
  // a constant, so unrolled, the loads of every pass start before the
  // first pass's arithmetic ---------------------------------------------
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
      const float vy = vat(0, is, js), vx = vat(1, is, js);
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
  // --- the gather of g_u, all kBwdRows rows at once. A tap lies at offset
  // d, e in [-(R - 1), R] of its source (d, e = -R add only zeros). The
  // sources' rows are walked from the lowest up, so each of the thread's
  // rows sees d ascending, and each mask is read once. -------------------
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
                out, hw, (int64_t)i * w + j, i, j, h, w, dt, r, acc[k][0],
                acc[k][1], tap);
  }
  __syncthreads();                  // before the next tile's staging
}

// The shared memory of the runtime-R tile (bwd_tile_chunked), carved from
// one buffer of chunk_smem_bytes().
struct ChunkSmem {
  float4 *s_py, *s_px, *c_g;
  float2 *s_v, *s_m, *c_w;
  // the near taps' offsets, doubled, plus 1 where a far tap lies beyond
  int2* c_t;
  __device__ explicit ChunkSmem(float4* base)
      : s_py(base), s_px(base + kN1), c_g(base + 2 * kN1),
        s_v(reinterpret_cast<float2*>(c_g + kChunkH * kChunkW)),
        s_m(s_v + kN1), c_w(s_m + kN1),
        c_t(reinterpret_cast<int2*>(c_w + kChunkH * kChunkW)) {}
};

__host__ __device__ constexpr size_t chunk_smem_bytes() {
  return (size_t)kN1 * 48 + (size_t)kChunkH * kChunkW * 32;
}

// K3's tile at any other radius R >= 1, given at run time. The tile's
// sources (tile +- R, clipped to the plane) outgrow shared memory as R
// grows, so they are staged kChunkH x kChunkW at a time, chunks from the
// right and from the bottom, and each thread gathers from a chunk before the
// next replaces it: for each of its pixels e still ascends over the chunks'
// columns and d over each column's rows. A source's taps are kept as
// offsets, not bit masks, so any R fits, and a pixel's own taps of u are
// read from device memory. Arguments as bwd_tile's; it ends with a barrier.
template <class V, class Out>
__device__ __forceinline__ void bwd_tile_chunked(
    ChunkSmem sm, V vat, const float* mb, const float* ub, const float* gmb,
    const float* gub, Out out, int tx0, int ty0, int h, int w, float dt,
    int R) {
  const float r = (float)(R - 1);
  const int64_t hw = (int64_t)h * w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = tx0 + lane, i0 = ty0 + warp * kBwdRows;
  const int r_lo = max(ty0 - R, 0), r_hi = min(ty0 + kBwdTileH + R, h);
  const int c_lo = max(tx0 - R, 0), c_hi = min(tx0 + kBwdTileW + R, w);

  for (int k = tid; k < kN1; k += kBwdThreads) {   // the halo-1 planes
    const int hr = k / kW1, hc = k - hr * kW1;
    const int is = ty0 - 1 + hr, js = tx0 - 1 + hc;
    float2 vv = make_float2(0.0f, 0.0f), mm = vv;
    float4 py = make_float4(0.0f, 0.0f, 0.0f, 0.0f), px = py;
    if (is >= 0 && is < h && js >= 0 && js < w) {
      const int64_t q = (int64_t)is * w + js;
      ad_products(vat(0, is, js), vat(1, is, js), mb, gmb, hw, q, dt, vv,
                  mm, py, px);
    }
    sm.s_v[k] = vv;
    sm.s_m[k] = mm;
    sm.s_py[k] = py;
    sm.s_px[k] = px;
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
        const Axis ay = axis_coord(is, -dt * vat(0, is, js), r, h);
        const Axis ax = axis_coord(js, -dt * vat(1, is, js), r, w);
        sm.c_t[k] = make_int2(2 * (ay.a0 - is) + (ay.a1 != ay.a0 ? 1 : 0),
                              2 * (ax.a0 - js) + (ax.a1 != ax.a0 ? 1 : 0));
        source_weights(ay, ax, __ldg(gub + q), __ldg(gub + hw + q),
                       sm.c_w[k], sm.c_g[k]);
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
          const int2 t = sm.c_t[ks];
          const int oy = t.x >> 1, ox = t.y >> 1;
          const bool far_x = e != ox;
          if (far_x && !((t.y & 1) && e == ox + 1)) continue;
#pragma unroll
          for (int k = 0; k < kBwdRows; ++k) {
            const int d = i0 + k - is;
            const bool far_y = d != oy;
            if (far_y && !((t.x & 1) && d == oy + 1)) continue;
            const float2 wy = sm.c_w[ks];
            const float4 g = sm.c_g[ks];
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
    bwd_outputs(sm.s_v, sm.s_m, sm.s_py, sm.s_px, (lr + 1) * kW1 + lane + 1,
                gmb, gub, out, hw, (int64_t)i * w + j, i, j, h, w, dt, r,
                acc[k][0], acc[k][1], tap);
  }
  __syncthreads();                  // before the next tile's staging
}

// K3 at a compiled radius R (1 or 2).
template <int R>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
epdiff_step_bwd_tiled(const float* __restrict__ v,
                      const float* __restrict__ m,
                      const float* __restrict__ u,
                      const float* __restrict__ gmo,
                      const float* __restrict__ guo, float* __restrict__ gv,
                      float* __restrict__ gm, float* __restrict__ gu,
                      int n_items, int h, int w, float dt) {
  extern __shared__ float4 smem4[];
  const int64_t hw = (int64_t)h * w;
  const int tx0 = blockIdx.x * kBwdTileW, ty0 = blockIdx.y * kBwdTileH;
  for (int n = blockIdx.z; n < n_items; n += gridDim.z) {
    const int64_t base = (int64_t)n * 2 * hw;
    bwd_tile<R>(smem4, Planes{v + base, hw, w}, m + base, u + base,
                gmo + base, guo + base,
                GlobalGrads{gv + base, gm + base, gu + base, hw}, tx0, ty0,
                h, w, dt);
  }
}

// K3 at any other radius (bwd_tile_chunked).
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
epdiff_step_bwd_chunked(const float* __restrict__ v,
                        const float* __restrict__ m,
                        const float* __restrict__ u,
                        const float* __restrict__ gmo,
                        const float* __restrict__ guo, float* __restrict__ gv,
                        float* __restrict__ gm, float* __restrict__ gu,
                        int n_items, int h, int w, float dt, int R) {
  __shared__ float4 smem4[chunk_smem_bytes() / sizeof(float4)];
  const int64_t hw = (int64_t)h * w;
  const int tx0 = blockIdx.x * kBwdTileW, ty0 = blockIdx.y * kBwdTileH;
  for (int n = blockIdx.z; n < n_items; n += gridDim.z) {
    const int64_t base = (int64_t)n * 2 * hw;
    bwd_tile_chunked(ChunkSmem(smem4), Planes{v + base, hw, w}, m + base,
                     u + base, gmo + base, guo + base,
                     GlobalGrads{gv + base, gm + base, gu + base, hw}, tx0,
                     ty0, h, w, dt, R);
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
// recomputed v (K is self-adjoint). Neither v nor g_v leaves the kernel,
// and nothing is saved for the backward, as on the TPU.
//
// What bounds them on the H100: a solve is four products, 4 H W (H + W)
// flops a channel (K6 solves 2 planes an item, K7 4). At the flagship's
// 64^2 items that is about 35 flops for every byte a kernel must move:
// above the f32 CUDA cores' balance (67 TFLOP/s over 3.35 TB/s, 20 flops a
// byte), below the TF32 tensor cores' (495 over 3.35, 148) even at three
// products each (3xTF32). On the tensor cores the bound is bytes (K6 at
// 64^2) or the products (the rest), and neither is what holds the kernels
// back: each block runs a chain of a dozen dependent phases (four products
// a solve, each a staging round trip, a barrier and a short k loop; the
// cluster barriers; phase B), with about 1.5 blocks resident an SM, so
// latency and instruction issue set the time (PERF.md, from chip_smoke.py
// and tools/k6k7_phases.py).
//
// Design:
//  - A cluster of CL = ceil(H / 16) blocks an item (at most 8); the block of
//    rank b owns rows 16 b .. 16 b + 15 of the item (the last band may be
//    ragged), so 190 items of 64^2 run as 760 blocks, not 190.
//  - The products run on the tensor cores (mma.sync m16n8k8 in TF32) in
//    3xTF32: each f32 operand splits into hi (rounded to TF32) and lo = x -
//    hi, and three f32 accumulators take lo hi, hi lo and hi hi, which keeps
//    f32-level accuracy (the plain version's products are full f32; one
//    TF32 product keeps about three digits). A band is one 16-row tile;
//    each warp owns 8-column tiles of both channels at once, so the operand
//    the channels share (Ty or Tx) is read once for both. The k order is
//    fixed, so two launches give the same bits.
//  - Operands go through shared memory: the A band from device memory once
//    a product; B up to 64 rows at a time (band_mm's chunk), by cp.async
//    from device memory or, from the cluster, a band buffer at a time.
//  - Products 1, 2, the weight and 4 are row-local: a block forms its band
//    of Ty m (m read from device memory), of (P1 Tx^T) * W and of P3 Tx.
//    Product 3, Ty^T P2, needs every row of P2: after a cluster barrier a
//    block copies the other blocks' bands of P2 from their shared memory
//    (distributed shared memory). v stays in shared memory, in bands.
//  - Phase B: K6 runs K2's per-pixel body on its band, reading v from its
//    shared memory with the neighbours' edge rows copied beside it
//    (HaloBand); K7 runs K3's tile bodies (bwd_tile; bwd_tile_chunked
//    beyond R = 2) on its band's 32 x 16 tiles, reading v through
//    ClusterPlanes (the halo of R + 1 rows from the neighbours), and keeps
//    g_v and K3's g_m in shared memory. The rows of u (and gm', gu') that
//    phase B reads are prefetched into L2 while the products run.
//  - Phase C (K7): g_m += K g_v by the same four products, product 1 now
//    reading g_v across the cluster; only the sum goes to device memory.
// The wrappers allocate no workspace: the C entries keep the scratch
// argument of the earlier design, unused, so that a build of that design
// is timed through the same call.

constexpr int kThreads = kBwdThreads;    // K3's tile bodies run inside K7
constexpr int kWarps = kThreads / 32;
constexpr int kBand = kBwdTileH;         // the rows of an item a block owns
constexpr int kMaxSide = 128;            // epdiff_pallas._MAX_SOLVE_SIDE

// The row pitch of a band buffer: W rounded up to 8, plus 4, so that the 32
// reads of an A fragment fall in 32 banks.
__host__ __device__ constexpr int band_pitch(int w) {
  return ((w + 7) & ~7) + 4;
}
// The floats of a band buffer: both channels' kBand rows.
__host__ __device__ constexpr int band_floats(int w) {
  return 2 * kBand * band_pitch(w);
}
// The blocks of an item's cluster.
__host__ __device__ constexpr int solve_cluster(int h) {
  return (h + kBand - 1) / kBand;
}

// The block's share of its item: item n, rank in the cluster, rows row0 ..
// row0 + rows - 1.
struct Band { int n, rank, row0, rows; };

__device__ __forceinline__ Band band_of(int h) {
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = rank * kBand;
  return {(int)(blockIdx.x / cluster.num_blocks()), rank, row0,
          max(0, min(kBand, h - row0))};
}

// A (2, H, W) pair of planes of one item that its cluster keeps in bands:
// the block of rank b holds rows kBand b .. kBand b + kBand - 1 of both
// channels in its own buffer at the same offset (own). row(i) is channel
// 0's row i; f(c, i, j) reads another block's rows through distributed
// shared memory.
struct ClusterPlanes {
  float* own;
  int rank, pitch;
  __device__ __forceinline__ const float* row(int i) const {
    const int b = i / kBand;
    const float* base =
        b == rank ? own : cg::this_cluster().map_shared_rank(own, b);
    return base + (i - b * kBand) * pitch;
  }
  __device__ __forceinline__ float operator()(int c, int i, int j) const {
    return row(i)[c * kBand * pitch + j];
  }
};

// An operand of band_mm in one piece of memory: element (r, q) of channel c
// at p[c * cs + r * rs + q * qs].
struct View {
  const float* p;
  int cs, rs, qs;
};

// hi = x rounded to TF32 (to nearest, ties away from zero: half the
// weight of the 13 bits below TF32's 10 mantissa bits added, then those
// bits cleared; x finite), lo = x - hi, exact. The mma reads lo's top 10
// mantissa bits, so hi + lo is x to about 2^-21 of x. Three instructions;
// cvt.rna.tf32.f32 takes about ten, as it also handles inf and NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b on one 16 x 8 tile with k = 8: TF32 inputs, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Asynchronous copies of one f32, or of 16 aligned bytes, from device
// memory to shared memory (cp.async; cp_async_wait waits for all of the
// thread's).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Brings rows lo .. hi - 1 (clipped to the plane's h rows) of both
// channels of an item's (2, H, W) planes at p into L2, a 128-byte line a
// thread, so that a later phase finds them there.
__device__ __forceinline__ void prefetch_rows(const float* p, int64_t hw,
                                              int w, int h, int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, h);
  const int len = (hi - lo) * w;
  for (int c = 0; c < 2; ++c)
    for (int o = threadIdx.x * 32; o < len; o += kThreads * 32)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          p + c * hw + (int64_t)lo * w + o));
}

// Copies element (c, r, q) of v (c < nc, r < nr, q < nq) from device memory
// to dst[(c * crows + r) * pitch + q] (pitch a multiple of 4) by cp.async,
// not waited for. Where v's columns are contiguous a warp's lanes take
// consecutive columns, 16 bytes a copy where v's rows and channels start on
// 16 bytes and nq is a multiple of 4; where its rows are contiguous,
// consecutive rows (nr <= 16).
__device__ __forceinline__ void stage_view(View v, int nc, int nr, int nq,
                                           float* dst, int crows,
                                           int pitch) {
  const int tid = threadIdx.x;
  if (v.qs == 1) {
    if (nq % 4 == 0 && v.rs % 4 == 0 && v.cs % 4 == 0
        && (reinterpret_cast<uintptr_t>(v.p) & 15) == 0) {
      const int nq4 = nq / 4;
      const int span = nq4 > 16 ? 32 : nq4 > 8 ? 16 : nq4 > 4 ? 8 : 4;
      const int q = (tid & (span - 1)) * 4;
      if (q >= nq) return;
      for (int c = 0; c < nc; ++c)
        for (int r = tid / span; r < nr; r += kThreads / span)
          cp_async_16(dst + (c * crows + r) * pitch + q,
                      v.p + c * v.cs + r * v.rs + q);
      return;
    }
    const int span = nq > 64 ? 128 : nq > 32 ? 64 : 32;
    const int q = tid & (span - 1);
    if (q >= nq) return;
    for (int c = 0; c < nc; ++c)
      for (int r = tid / span; r < nr; r += kThreads / span)
        cp_async_f32(dst + (c * crows + r) * pitch + q,
                     v.p + c * v.cs + r * v.rs + q);
  } else {
    const int r = tid % kBand;
    if (r >= nr) return;
    for (int c = 0; c < nc; ++c)
      for (int q = tid / kBand; q < nq; q += kThreads / kBand)
        cp_async_f32(dst + (c * crows + r) * pitch + q,
                     v.p + c * v.cs + r * v.rs + q * v.qs);
  }
}

// How band_mm keeps the rows c0 .. c0 + kBand nb - 1 of its B in chunk:
//  kRows: B read from device memory by rows: element (c, kk, j) at
//    (c kBand nb + kk) pitch + j, pitch = band_pitch(n);
//  kCols: B = Tx^T, read from device memory by Tx's rows: (kk, j) at
//    j pitchT + kk, pitchT = band_pitch(kBand nb);
//  kBands: B kept in bands by the cluster (ClusterPlanes), copied a band
//    buffer at a time: (c, kk, j) at ((kk / kBand * 2 + c) kBand + kk %
//    kBand) pitch + j.
enum ChunkLayout { kRows, kCols, kBands };

// Stages rows c0 .. c0 + kBand nb - 1 (those < k) of b (NC channels, n
// columns) into chunk, laid out as L says: from device memory by cp.async;
// from the cluster's bands (c0 a multiple of kBand, nb band_pitch(n) <=
// kMaxChunkPitch) through distributed shared memory, 16 bytes a load, every
// load before the first store. Complete after cp_async_wait() and a
// barrier.
constexpr int kMaxChunkPitch = 272;      // 4 bands of pitch 68, 2 of 132

template <int NC, ChunkLayout L>
__device__ __forceinline__ void stage_rows(View b, float* chunk, int c0,
                                           int k, int n, int nb) {
  const int rows = min(kBand * nb, k - c0);
  if constexpr (L == kCols)
    stage_view(View{b.p + c0, 0, b.qs, 1}, 1, n, rows, chunk, 0,
               band_pitch(kBand * nb));
  else
    stage_view(View{b.p + c0 * b.rs, b.cs, b.rs, 1}, NC, rows, n,
               chunk, kBand * nb, band_pitch(n));
}

template <int NC, ChunkLayout L>
__device__ __forceinline__ void stage_rows(ClusterPlanes b, float* chunk,
                                           int c0, int k, int, int nb) {
  constexpr int kS = (2 * kBand * kMaxChunkPitch / 4 + kThreads - 1)
                     / kThreads;
  const int per = 2 * kBand * b.pitch / 4;   // float4 in a band buffer
  const int total = min(nb, (k - c0 + kBand - 1) / kBand) * per;
  float4* dst = reinterpret_cast<float4*>(chunk);
  float4 val[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int e = threadIdx.x + s * kThreads;
    if (e < total) {
      const int bi = e / per;
      val[s] = reinterpret_cast<const float4*>(
          b.row(c0 + bi * kBand))[e - bi * per];
    }
  }
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int e = threadIdx.x + s * kThreads;
    if (e < total) dst[e] = val[s];
  }
}

// A_c B_c for both channels c of the block's band, on the tensor cores in
// 3xTF32, with NT column tiles a warp: A_c is kBand x k (rows i < rows;
// zero beyond), B_c is k x n, staged kBand nb rows at a time as L says.
// kShareA: one A for both channels, in device memory (Ty or Ty^T), staged
// once into abuf (kBand rows of band_pitch(k)); else one B, and A in shared
// memory (a band buffer). store(c, i, j, value) takes each element of rows
// i < rows, columns j < n. Every thread of the block calls it.
//
// Each chunk costs one round trip to B's source. Warp w owns the 8-column
// tiles from 8 w and from 8 w + 8 kWarps (NT = 2), both channels, and holds
// each fragment it loads for all of them. The fragments are mma.m16n8k8's:
// lane = 4 g + t holds A's (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4),
// B's (t, g), (t + 4, g), and the sums' (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1). lo hi, hi lo and hi hi are summed apart: three
// independent dependency chains, and the small terms' rounding stays small.
template <bool kShareA, ChunkLayout L, int NT, class B, class S>
__device__ __forceinline__ void band_mm_tiles(int k, int n, int rows, View a,
                                              B b, float* chunk, int nb,
                                              float* abuf, S store) {
  constexpr int kCA = kShareA ? 1 : 2, kCB = kShareA ? 2 : 1;
  const int pitch = band_pitch(n), pitch_t = band_pitch(kBand * nb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool active = warp * 8 < n;          // the warp owns a column
  const bool ra0 = g < rows, ra1 = g + 8 < rows;
  if (kShareA) {
    stage_view(a, 1, rows, k, abuf, kBand, band_pitch(k));
    a = View{abuf, 0, band_pitch(k), 1};
  }
  const float* pa = a.p + g * a.rs + t;
  const int a8 = 8 * a.rs;
  bool cb[NT];
  int col[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    col[q] = warp * 8 + q * 8 * kWarps + g;
    cb[q] = col[q] < n;
  }
  // B's (t, col) in the chunk: ob + c * oc + kk_base * ok; (t + 4, col):
  // that + o4
  const int ok = L == kCols ? 1 : pitch;
  const int oc = L == kRows ? kBand * nb * pitch : kBand * pitch;
  const int o4 = 4 * ok;
  float big[2][NT][4] = {}, small[2][2][NT][4] = {};
  for (int c0 = 0; c0 < k; c0 += kBand * nb) {
    stage_rows<kCB, L>(b, chunk, c0, k, n, nb);
    cp_async_wait();
    __syncthreads();
    const int n_bands = min(nb, (k - c0 + kBand - 1) / kBand);
    for (int bi = 0; active && bi < n_bands; ++bi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k0 = c0 + bi * kBand + 8 * half;
        if (k0 >= k) break;
        const bool k_lo = k0 + t < k, k_hi = k0 + t + 4 < k;
        // the chunk's row of B's element (t, .) of this k step
        const int kb = L == kBands ? 2 * bi * kBand * pitch
                                       + (8 * half + t) * pitch
                                   : (bi * kBand + 8 * half + t) * ok;
        uint32_t ah[kCA][4], al[kCA][4], bh[kCB][NT][2], bl[kCB][NT][2];
#pragma unroll
        for (int c = 0; c < kCA; ++c) {
          const float* p = pa + c * a.cs + k0;
          split_tf32(ra0 && k_lo ? p[0] : 0.0f, ah[c][0], al[c][0]);
          split_tf32(ra1 && k_lo ? p[a8] : 0.0f, ah[c][1], al[c][1]);
          split_tf32(ra0 && k_hi ? p[4] : 0.0f, ah[c][2], al[c][2]);
          split_tf32(ra1 && k_hi ? p[a8 + 4] : 0.0f, ah[c][3], al[c][3]);
        }
#pragma unroll
        for (int c = 0; c < kCB; ++c)
#pragma unroll
          for (int q = 0; q < NT; ++q) {
            const float* p = chunk + kb + c * oc
                             + (L == kCols ? col[q] * pitch_t : col[q]);
            split_tf32(cb[q] && k_lo ? p[0] : 0.0f, bh[c][q][0], bl[c][q][0]);
            split_tf32(cb[q] && k_hi ? p[o4] : 0.0f, bh[c][q][1],
                       bl[c][q][1]);
          }
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int q = 0; q < NT; ++q) {
            const int ca = kShareA ? 0 : c, cbi = kShareA ? c : 0;
            mma_tf32(small[0][c][q], al[ca], bh[cbi][q]);
            mma_tf32(small[1][c][q], ah[ca], bl[cbi][q]);
            mma_tf32(big[c][q], ah[ca], bh[cbi][q]);
          }
      }
    }
    __syncthreads();                         // before the next staging
  }
  if (!active) return;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = g + 8 * (e >> 1), j = col[q] - g + 2 * t + (e & 1);
        if (i < rows && j < n)
          store(c, i, j,
                big[c][q][e] + (small[0][c][q][e] + small[1][c][q][e]));
      }
}

// band_mm_tiles with one column tile a warp up to n = 64, two beyond (n <=
// 128).
template <bool kShareA, ChunkLayout L, class B, class S>
__device__ __forceinline__ void band_mm(int k, int n, int rows, View a, B b,
                                        float* chunk, int nb, float* abuf,
                                        S store) {
  if (n > 8 * kWarps)
    band_mm_tiles<kShareA, L, 2>(k, n, rows, a, b, chunk, nb, abuf, store);
  else
    band_mm_tiles<kShareA, L, 1>(k, n, rows, a, b, chunk, nb, abuf, store);
}

// The shared memory band_solve works in: sa, the block's own band buffer
// (P1, P3); sb, the one the cluster reads (P2); chunk, nb band buffers, and
// abuf, kBand rows of band_pitch(H), for band_mm.
struct SolveSmem { float *sa, *sb, *chunk, *abuf; int nb; };

// The band buffers of a chunk: 4 up to 64 px a row, else 2 (K6) or 1 (K7,
// whose shared memory must leave room for two blocks an SM).
__host__ __device__ constexpr int chunk_bands(int w, bool bwd) {
  return w <= 64 ? 4 : bwd ? 1 : 2;
}

// The floats of a SolveSmem.
__host__ __device__ constexpr int solve_smem_floats(int h, int w, bool bwd) {
  return (2 + chunk_bands(w, bwd)) * band_floats(w) + kBand * band_pitch(h);
}

// K x on the block's band of one item, both channels, in the order of
// epdiff_pallas.py:_solve_mm: P1 = Ty x, P2 = (P1 Tx^T) * W, P3 = Ty^T P2,
// P4 = P3 Tx. x (a View or ClusterPlanes) holds every row of x; store(c, i,
// j, value) takes the band's rows of P4. Every thread of the cluster calls
// it. A cluster barrier follows P2; one follows P3 too with kLast (no block
// reads this block's P2 after it, so the block may exit after P4), else a
// block barrier.
template <bool kLast, class X, class S>
__device__ __forceinline__ void band_solve(X x, const float* __restrict__ ty,
                                           const float* __restrict__ tx,
                                           const float* __restrict__ wgt,
                                           SolveSmem sm, Band bd, int h,
                                           int w, S store) {
  const int pitch = band_pitch(w);
  const View a_band{sm.sa, kBand * pitch, pitch, 1};
  const auto to_a = [&](int c, int i, int j, float val) {
    sm.sa[(c * kBand + i) * pitch + j] = val;
  };
  // x is whole in device memory (a View) or in the cluster's bands
  constexpr ChunkLayout kXLayout = std::is_same_v<X, View> ? kRows : kBands;
  band_mm<true, kXLayout>(                             // P1 = Ty x
      h, w, bd.rows, View{ty + bd.row0 * h, 0, h, 1}, x, sm.chunk, sm.nb,
      sm.abuf, to_a);
  __syncthreads();
  band_mm<false, kCols>(w, w, bd.rows, a_band, View{tx, 0, 1, w},  // P2
                        sm.chunk, sm.nb, sm.abuf,
                        [&](int c, int i, int j, float val) {
                          sm.sb[(c * kBand + i) * pitch + j] =
                              val * __ldg(wgt + (bd.row0 + i) * w + j);
                        });
  cg::this_cluster().sync();          // every band of P2 is in place
  band_mm<true, kBands>(h, w, bd.rows, View{ty + bd.row0, 0, 1, h},  // P3
                        ClusterPlanes{sm.sb, bd.rank, pitch}, sm.chunk,
                        sm.nb, sm.abuf, to_a);
  if (kLast) cg::this_cluster().sync();
  else __syncthreads();
  band_mm<false, kRows>(w, w, bd.rows, a_band, View{tx, 0, w, 1},  // P4
                        sm.chunk, sm.nb, sm.abuf, store);
}

// v's band with a row of its neighbours' above and below (kBand + 2 rows a
// channel): v(c, i, j) is channel c at row i of the item, i in row0 - 1 ..
// row0 + kBand.
struct HaloBand {
  float* p;
  int row0, pitch;
  __device__ __forceinline__ float* at(int c, int i, int j) const {
    return p + (c * (kBand + 2) + i - row0 + 1) * pitch + j;
  }
  __device__ __forceinline__ float operator()(int c, int i, int j) const {
    return *at(c, i, j);
  }
};

// K6: one item a cluster; dynamic shared memory: band_solve's
// (solve_smem_floats), then v's HaloBand.
__global__ void __launch_bounds__(kThreads, 2) epdiff_step_solve_fwd_kernel(
    const float* __restrict__ m, const float* __restrict__ u,
    const float* __restrict__ ty, const float* __restrict__ tx,
    const float* __restrict__ wgt, float* __restrict__ m_out,
    float* __restrict__ u_out, int h, int w, float dt, float r) {
  extern __shared__ float4 smem4[];
  const Band bd = band_of(h);
  const int pitch = band_pitch(w);
  float* sa = reinterpret_cast<float*>(smem4);
  const SolveSmem sm{sa, sa + band_floats(w), sa + 2 * band_floats(w),
                     sa + (2 + chunk_bands(w, false)) * band_floats(w),
                     chunk_bands(w, false)};
  float* sv = sa + solve_smem_floats(h, w, false);
  const int64_t hw = (int64_t)h * w;
  const int64_t base = (int64_t)bd.n * 2 * hw;
  // u's rows that phase B's taps reach, into L2 while the products run
  prefetch_rows(u + base, hw, w, h, bd.row0 - (int)r - 1,
                bd.row0 + bd.rows + (int)r + 1);
  const HaloBand v{sv, bd.row0, pitch};
  band_solve<false>(View{m + base, (int)hw, w, 1}, ty, tx, wgt, sm, bd, h,
                    w, [&](int c, int i, int j, float val) {  // phase A
                      *v.at(c, bd.row0 + i, j) = val;
                    });
  cg::this_cluster().sync();          // every band of v is in place
  // the halo rows from the neighbours' shared memory
  const cg::cluster_group cluster = cg::this_cluster();
  for (int e = threadIdx.x; e < 4 * w; e += kThreads) {
    const int c = e / (2 * w), below = (e / w) & 1, j = e % w;
    const int i = below ? bd.row0 + kBand : bd.row0 - 1;
    if (i < 0 || i >= h) continue;
    const HaloBand nb{cluster.map_shared_rank(sv, bd.rank + (below ? 1 : -1)),
                      bd.row0 + (below ? kBand : -kBand), pitch};
    *v.at(c, i, j) = nb(c, i, j);
  }
  cluster.sync();                     // no block reads another's v now
  const Planes mp{m + base, hw, w};
  // phase B: the band's pixels, a fixed count of passes, unrolled so that
  // the loads of several pixels are in flight at once
#pragma unroll
  for (int s = 0; s < kBand * kMaxSide / kThreads; ++s) {
    const int e = threadIdx.x + s * kThreads;
    if (e < bd.rows * w) {
      const int li = e / w, j = e - li * w, i = bd.row0 + li;
      step_fwd_pixel(v, mp, u + base, m_out + base, u_out + base,
                     (int64_t)i * w + j, i, j, h, w, dt, r);
    }
  }
}

// The bytes of K7's first region of shared memory: the staging of K3's tile
// (bwd_tile<RC>'s, or with RC = 0 bwd_tile_chunked's) in phase B,
// band_solve's in phases A and C.
template <int RC>
__host__ __device__ constexpr size_t solve_bwd_stage_bytes(int h, int w) {
  size_t stage = 0;
  if constexpr (RC > 0) stage = bwd_smem_bytes<RC>();
  else stage = chunk_smem_bytes();
  const size_t solve = (size_t)solve_smem_floats(h, w, true) * sizeof(float);
  return stage > solve ? stage : solve;
}

// K7: one item a cluster; RC is K3's compiled tile radius (1, 2), or 0 for
// its runtime-R tile at radius R. Dynamic shared memory: the first region
// (solve_bwd_stage_bytes), then 3 band buffers (v; g_v; K3's g_m). Phase B
// stages its tiles where the products work: between phase A's last read of
// P2 by the cluster and phase C's first write, two cluster barriers.
template <int RC>
__global__ void __launch_bounds__(kThreads, 2) epdiff_step_solve_bwd_kernel(
    const float* __restrict__ m, const float* __restrict__ u,
    const float* __restrict__ ty, const float* __restrict__ tx,
    const float* __restrict__ wgt, const float* __restrict__ gmo,
    const float* __restrict__ guo, float* __restrict__ gm,
    float* __restrict__ gu, int h, int w, float dt, int R) {
  extern __shared__ float4 smem4[];
  const Band bd = band_of(h);
  const int pitch = band_pitch(w);
  float4* stage = smem4;
  float* sa = reinterpret_cast<float*>(smem4);
  const SolveSmem sm{sa, sa + band_floats(w), sa + 2 * band_floats(w),
                     sa + (2 + chunk_bands(w, true)) * band_floats(w),
                     chunk_bands(w, true)};
  float* sv = reinterpret_cast<float*>(
      smem4 + solve_bwd_stage_bytes<RC>(h, w) / sizeof(float4));
  float* sgv = sv + band_floats(w);
  float* sgm = sgv + band_floats(w);
  const int64_t hw = (int64_t)h * w;
  const int64_t base = (int64_t)bd.n * 2 * hw;
  // the rows of u, gm', gu' that phase B's tiles stage, into L2 meanwhile
  const int lo = bd.row0 - R - 1, hi = bd.row0 + kBand + R + 1;
  prefetch_rows(u + base, hw, w, h, lo, hi);
  prefetch_rows(gmo + base, hw, w, h, lo, hi);
  prefetch_rows(guo + base, hw, w, h, lo, hi);
  band_solve<false>(View{m + base, (int)hw, w, 1}, ty, tx, wgt, sm, bd, h, w,
                    [&](int c, int i, int j, float val) {   // phase A: v
                      sv[(c * kBand + i) * pitch + j] = val;
                    });
  cg::this_cluster().sync();          // every band of v is in place

  // phase B: K3 on the band's tiles; g_v and g_m into shared memory
  const auto out = [&](int64_t p, int i, int j, float gvy, float gvx,
                       float gmy, float gmx, float gu0, float gu1) {
    const int o = (i - bd.row0) * pitch + j, o1 = o + kBand * pitch;
    sgv[o] = gvy;
    sgv[o1] = gvx;
    sgm[o] = gmy;
    sgm[o1] = gmx;
    gu[base + p] = gu0;
    gu[base + hw + p] = gu1;
  };
  const ClusterPlanes v{sv, bd.rank, pitch};
  for (int tx0 = 0; tx0 < w; tx0 += kBwdTileW) {
    if constexpr (RC > 0)
      bwd_tile<RC>(stage, v, m + base, u + base, gmo + base, guo + base, out,
                   tx0, bd.row0, h, w, dt);
    else
      bwd_tile_chunked(ChunkSmem(stage), v, m + base, u + base, gmo + base,
                       guo + base, out, tx0, bd.row0, h, w, dt, R);
  }
  cg::this_cluster().sync();          // every band of g_v is in place

  // phase C: g_m = K3's g_m + K g_v
  band_solve<true>(ClusterPlanes{sgv, bd.rank, pitch}, ty, tx, wgt, sm, bd,
                   h, w, [&](int c, int i, int j, float val) {
                     gm[base + c * hw + (int64_t)(bd.row0 + i) * w + j] =
                         sgm[(c * kBand + i) * pitch + j] + val;
                   });
}

// Launches kernel on n items, a cluster of cl blocks of kThreads threads an
// item, with smem bytes of dynamic shared memory; the attributes first.
template <class... P, class... A>
cudaError_t launch_clusters(void (*kernel)(P...), int n, int cl, size_t smem,
                            cudaStream_t stream, A... args) {
  if ((int64_t)n * cl > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * cl));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
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

// m, u, m_out, u_out: (N, 2, H, W); ty (H, H), tx (W, W), wgt (H, W). All
// f32, contiguous, on the current device; 2 <= H, W <= 128, radius >= 1
// (cudaErrorInvalidValue otherwise). scratch is not used. Returns
// cudaGetLastError().
extern "C" int epdiff_step_solve_fwd(const float* m, const float* u,
                                     const float* ty, const float* tx,
                                     const float* wgt, float* m_out,
                                     float* u_out, float* scratch, int n,
                                     int h, int w, float dt, int radius,
                                     cudaStream_t stream) {
  (void)scratch;
  if (n == 0) return (int)cudaSuccess;
  if (h < 2 || w < 2 || h > kMaxSide || w > kMaxSide || radius < 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch_clusters(
      epdiff_step_solve_fwd_kernel, n, solve_cluster(h),
      (size_t)(solve_smem_floats(h, w, false) + 2 * (kBand + 2) * band_pitch(w))
          * sizeof(float),
      stream, m, u, ty, tx, wgt,
      m_out, u_out, h, w, dt, (float)(radius - 1));
}

// m, u, gm_out, gu_out (the cotangents of m', u') -> gm, gu: (N, 2, H, W);
// operands as above; 4 <= H, W <= 128, radius >= 1 (cudaErrorInvalidValue
// otherwise). scratch is not used. Returns cudaGetLastError().
extern "C" int epdiff_step_solve_bwd(const float* m, const float* u,
                                     const float* ty, const float* tx,
                                     const float* wgt, const float* gm_out,
                                     const float* gu_out, float* gm,
                                     float* gu, float* scratch, int n, int h,
                                     int w, float dt, int radius,
                                     cudaStream_t stream) {
  (void)scratch;
  if (n == 0) return (int)cudaSuccess;
  if (h < 4 || w < 4 || h > kMaxSide || w > kMaxSide || radius < 1)
    return (int)cudaErrorInvalidValue;
  const int cl = solve_cluster(h);
  const size_t bands = (size_t)3 * band_floats(w) * sizeof(float);
  if (radius <= 2) {
    const auto kernel = radius == 1 ? epdiff_step_solve_bwd_kernel<1>
                                    : epdiff_step_solve_bwd_kernel<2>;
    const size_t stage = radius == 1 ? solve_bwd_stage_bytes<1>(h, w)
                                     : solve_bwd_stage_bytes<2>(h, w);
    return (int)launch_clusters(kernel, n, cl, stage + bands, stream, m, u,
                                ty, tx, wgt, gm_out, gu_out, gm, gu, h, w, dt,
                                radius);
  }
  // beyond max(H, W) the clamp at radius - 1 bites nowhere the clip does not
  const int hw_max = h > w ? h : w;
  return (int)launch_clusters(
      epdiff_step_solve_bwd_kernel<0>, n, cl,
      solve_bwd_stage_bytes<0>(h, w) + bands, stream, m, u, ty, tx, wgt,
      gm_out, gu_out, gm, gu, h, w, dt, radius < hw_max ? radius : hw_max);
}
