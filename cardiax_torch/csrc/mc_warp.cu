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
// the minimum traffic is (C + 2) planes read and C planes written.
//
// Design: a thread owns 4 consecutive pixels of a row (block 32 x 8: 128
// columns of 8 rows), the row and the item in the grid's y and z, so no
// thread divides to find its pixel. The earlier design, one pixel a
// thread, left two dependent round trips to memory (the displacement, then
// the taps) with 8 bytes in flight a thread, and moved 1.5-1.6 TB/s. Here
// a thread loads both displacement planes as float4 where W % 4 == 0
// (scalar loads otherwise), computes its 4 coordinates, starts all 16 tap
// loads of a channel before any arithmetic, and stores a float4. The four
// taps of neighbouring threads overlap, so they hit L1/L2 rather than
// DRAM. Left to itself ptxas gives it 79 registers (3 blocks an SM); it is
// capped at 64 (4 blocks), which ran faster at B3's and B9's shapes and
// slower at B6's on an H100. f32 arithmetic and accumulation, with the
// clamp, the clip and the tap order of the one-pixel kernel, term for
// term.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kFwdQuads = 32;      // threads a block along a row
constexpr int kFwdRows = 8;        // rows a block
constexpr int kFwdMinBlocks = 4;   // blocks an SM: at most 64 registers

// vec: W % 4 == 0 and disp, out 16-byte aligned (every row is then too)
__global__ void __launch_bounds__(kFwdQuads * kFwdRows, kFwdMinBlocks)
mc_warp_fwd_kernel(const float* __restrict__ img,
                   const float* __restrict__ disp, float* __restrict__ out,
                   int n_items, int c, int h, int w, float r, bool vec) {
  const int j0 = 4 * (blockIdx.x * kFwdQuads + threadIdx.x);
  const int i = blockIdx.y * kFwdRows + threadIdx.y;
  if (i >= h || j0 >= w) return;
  const int64_t hw = (int64_t)h * w;
  const int row = i * w;
  const int nj = min(4, w - j0);
  for (int n = blockIdx.z; n < n_items; n += gridDim.z) {
    const float* d = disp + (int64_t)n * 2 * hw + row + j0;
    float dy[4], dx[4];
    if (vec) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(d));
      const float4 b = __ldg(reinterpret_cast<const float4*>(d + hw));
      dy[0] = a.x; dy[1] = a.y; dy[2] = a.z; dy[3] = a.w;
      dx[0] = b.x; dx[1] = b.y; dx[2] = b.z; dx[3] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dy[k] = k < nj ? __ldg(d + k) : 0.0f;
        dx[k] = k < nj ? __ldg(d + hw + k) : 0.0f;
      }
    }
    int o0[4], o1[4], ix0[4], ix1[4];       // row offsets y0, y1; columns
    float fy[4], fx[4], wy0[4], wx0[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float cdy = fminf(fmaxf(dy[k], -r), r);
      const float cdx = fminf(fmaxf(dx[k], -r), r);
      const float cy = fminf(fmaxf((float)i + cdy, 0.0f), (float)(h - 1));
      const float cx = fminf(fmaxf((float)(j0 + k) + cdx, 0.0f),
                             (float)(w - 1));
      const float y0 = floorf(cy);
      const float x0 = floorf(cx);
      fy[k] = cy - y0;
      fx[k] = cx - x0;
      const int iy0 = (int)y0;
      ix0[k] = (int)x0;
      o0[k] = iy0 * w;
      o1[k] = min(iy0 + 1, h - 1) * w;
      ix1[k] = min(ix0[k] + 1, w - 1);
      wy0[k] = 1.0f - fy[k];
      wx0[k] = 1.0f - fx[k];
    }
    for (int ch = 0; ch < c; ++ch) {
      const float* src = img + ((int64_t)n * c + ch) * hw;
      float t00[4], t10[4], t01[4], t11[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {          // every tap load first
        t00[k] = __ldg(src + o0[k] + ix0[k]);
        t10[k] = __ldg(src + o1[k] + ix0[k]);
        t01[k] = __ldg(src + o0[k] + ix1[k]);
        t11[k] = __ldg(src + o1[k] + ix1[k]);
      }
      float res[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // column x0 then column x1, rows y0 then y1: the tap order of the
        // TPU kernel's band sweep
        const float col0 = wy0[k] * t00[k] + fy[k] * t10[k];
        const float col1 = wy0[k] * t01[k] + fy[k] * t11[k];
        res[k] = wx0[k] * col0 + fx[k] * col1;
      }
      float* dst = out + ((int64_t)n * c + ch) * hw + row + j0;
      if (vec) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(res[0], res[1], res[2], res[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nj) dst[k] = res[k];
      }
    }
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
// each), writes 2 planes: 74.7 MB at (190, 1, 128, 128), 0.0223 ms at 3.35
// TB/s; about 20 flops a channel.
//
// Design: the forward's layout. A thread owns 4 consecutive pixels of a row
// (block 32 x 8), the row and the item in the grid's y and z, so no thread
// divides to find its pixel. It loads dy, dx and, at C = 1, g as float4
// where W % 4 == 0 and disp, g and gdisp are 16-byte aligned (scalar loads,
// tail-masked, otherwise), all three before any arithmetic; computes its 4
// coordinates; starts all 16 tap loads before the terms; and stores gdy and
// gdx as float4. The earlier design, one pixel a thread, found its pixel by
// two 64-bit divisions, loaded the displacement, then the taps, and read g
// once a column: two dependent round trips with 8 bytes in flight a thread,
// 1.67 TB/s at (190, 1, 128, 128). At C > 1 the sum order (every
// channel's column-x0 term before the first column-x1 term) takes two
// passes over the channels, each loading g and its column's 8 taps before
// the terms: g is read twice there (no caller of the port passes C > 1).
// Registers (ptxas): left to itself the C = 1 path takes 93 (2 blocks an
// SM) and ran within 7% of the one-pixel kernel on an H100; capped at 64 (4
// blocks, no spill) it ran 23-30% faster at B4's, B6's and B9's shapes. At
// 80 (3 blocks) and 48 (5) it was slower than at 64 at all three shapes; at
// 40 (6) within 2% at B4 and B9 and 4% slower at B6. The C > 1 path fits 80
// registers (3 blocks) and spills at 64. f32 arithmetic and accumulation;
// the clamp, the clip, the masks, the sum order and the fused multiply-adds
// of the one-pixel kernel, term for term, so its output keeps that
// kernel's bits.

constexpr int kBwdQuads = 32;      // threads a block along a row
constexpr int kBwdRows = 8;        // rows a block
constexpr int kBwdMinBlocks = 4;   // blocks an SM at C = 1: 64 registers
constexpr int kBwdMinBlocksMulti = 3;  // at C > 1: 80 registers

// v[k] = p[k] for k < 4: one float4 where vec, else scalar loads of the nj
// pixels left in the row (0 beyond). K1 keeps its own inline loads and
// stores: through these two it compiled to code that ran 10% slower at
// B6's shape on an H100.
__device__ __forceinline__ void load_quad(const float* __restrict__ p,
                                          bool vec, int nj, float v[4]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = k < nj ? __ldg(p + k) : 0.0f;
  }
}

// p[k] = v[k] for the nj pixels left in the row: one float4 where vec
__device__ __forceinline__ void store_quad(float* __restrict__ p, bool vec,
                                           int nj, const float v[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < nj) p[k] = v[k];
  }
}

// One column's term of one channel: taps a (row y0) and b (row y1), the
// column's weight wc (1 - fx or fx) and its d hat / d x, sc (-sx or sx).
//   acc_dy += (wc * gc) * (b - a)
//   acc_dx += (sc * gc) * (wy0 * a + fy * b)
// with the fused multiply-adds written out as nvcc formed them for the
// earlier one-pixel kernel, so that both of K4's paths keep its bits
// whatever the compiler would contract in their code.
__device__ __forceinline__ void column_term(float& acc_dy, float& acc_dx,
                                            float wc, float sc, float gc,
                                            float a, float b, float wy0,
                                            float fy) {
  acc_dy = __fmaf_rn(__fmul_rn(wc, gc), b - a, acc_dy);
  acc_dx = __fmaf_rn(__fmul_rn(sc, gc), __fmaf_rn(wy0, a, __fmul_rn(fy, b)),
                     acc_dx);
}

// K5's d/d disp of one pixel p = (i, j) of item n: the formula above
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

// kOneChannel: C == 1, one pass; else two passes over the channels (the
// sum order). vec: W % 4 == 0 and disp, g, gdisp 16-byte aligned.
template <bool kOneChannel>
__global__ void __launch_bounds__(
    kBwdQuads * kBwdRows, kOneChannel ? kBwdMinBlocks : kBwdMinBlocksMulti)
mc_warp_disp_bwd_kernel(const float* __restrict__ img,
                        const float* __restrict__ disp,
                        const float* __restrict__ g,
                        float* __restrict__ gdisp, int n_items, int c, int h,
                        int w, float r, bool vec) {
  const int j0 = 4 * (blockIdx.x * kBwdQuads + threadIdx.x);
  const int i = blockIdx.y * kBwdRows + threadIdx.y;
  if (i >= h || j0 >= w) return;
  const int64_t hw = (int64_t)h * w;
  const int row = i * w;
  const int nj = min(4, w - j0);
  const float fi = (float)i;
  for (int n = blockIdx.z; n < n_items; n += gridDim.z) {
    const float* d = disp + (int64_t)n * 2 * hw + row + j0;
    const float* src = img + (int64_t)n * c * hw;
    const float* gq = g + (int64_t)n * c * hw + row + j0;
    float dy[4], dx[4], g0[4];
    load_quad(d, vec, nj, dy);
    load_quad(d + hw, vec, nj, dx);
    if (kOneChannel) load_quad(gq, vec, nj, g0);
    // tap offsets (y0, x0), (y1, x0), (y0, x1), (y1, x1)
    int o00[4], o10[4], o01[4], o11[4];
    float fy[4], fx[4], sx[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float cdy = fminf(fmaxf(dy[k], -r), r);
      const float cdx = fminf(fmaxf(dx[k], -r), r);
      const float cy = fminf(fmaxf(fi + cdy, 0.0f), (float)(h - 1));
      const float cx = fminf(fmaxf((float)(j0 + k) + cdx, 0.0f),
                             (float)(w - 1));
      const float y0 = floorf(cy), x0 = floorf(cx);
      fy[k] = cy - y0;
      fx[k] = cx - x0;
      const int iy0 = (int)y0, ix0 = (int)x0;
      const int ix1 = min(ix0 + 1, w - 1);
      const int r0 = iy0 * w, r1 = min(iy0 + 1, h - 1) * w;
      o00[k] = r0 + ix0;
      o10[k] = r1 + ix0;
      o01[k] = r0 + ix1;
      o11[k] = r1 + ix1;
      // d hat / d x on the two columns: -1, +1, or 0 for both when x1 == x0
      sx[k] = ix1 != ix0 ? 1.0f : 0.0f;
    }
    float acc_dy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float acc_dx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (kOneChannel) {
      float a0[4], b0[4], a1[4], b1[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {          // every tap load first
        a0[k] = __ldg(src + o00[k]);
        b0[k] = __ldg(src + o10[k]);
        a1[k] = __ldg(src + o01[k]);
        b1[k] = __ldg(src + o11[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float wy0 = 1.0f - fy[k];
        column_term(acc_dy[k], acc_dx[k], 1.0f - fx[k], -sx[k], g0[k], a0[k],
                    b0[k], wy0, fy[k]);
        column_term(acc_dy[k], acc_dx[k], fx[k], sx[k], g0[k], a1[k], b1[k],
                    wy0, fy[k]);
      }
    } else {
#pragma unroll
      for (int col = 0; col < 2; ++col) {    // column x0, then column x1
        const int* top = col == 0 ? o00 : o01;
        const int* bot = col == 0 ? o10 : o11;
        for (int ch = 0; ch < c; ++ch) {
          const float* s = src + ch * hw;
          float gc[4], a[4], b[4];
          load_quad(gq + ch * hw, vec, nj, gc);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            a[k] = __ldg(s + top[k]);
            b[k] = __ldg(s + bot[k]);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
            column_term(acc_dy[k], acc_dx[k], col == 0 ? 1.0f - fx[k] : fx[k],
                        col == 0 ? -sx[k] : sx[k], gc[k], a[k], b[k],
                        1.0f - fy[k], fy[k]);
        }
      }
    }
    float gdy[4], gdx[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float fj = (float)(j0 + k);
      const float my = (fabsf(dy[k]) <= r && fi + dy[k] >= 0.0f
                        && fi + dy[k] <= (float)(h - 1)) ? 1.0f : 0.0f;
      const float mx = (fabsf(dx[k]) <= r && fj + dx[k] >= 0.0f
                        && fj + dx[k] <= (float)(w - 1)) ? 1.0f : 0.0f;
      gdy[k] = acc_dy[k] * my;
      gdx[k] = acc_dx[k] * mx;
    }
    float* out = gdisp + (int64_t)n * 2 * hw + row + j0;
    store_quad(out, vec, nj, gdy);
    store_quad(out + hw, vec, nj, gdx);
  }
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
// (both terms add where a1 == a0 at the clip: warp_pallas.py:_hat). The TPU
// scatters by rolling weighted copies of g over the (2R+1)^2 band.
//
// Bound on the H100: bytes (disp, the field and g read, both outputs
// written: 3C + 4 planes). The function is a scatter of 4 terms a source;
// the cost is in making it deterministic.
//
// Design: output tiles of 64 x 32 pixels, one block of 256 threads each,
// the item in blockIdx.z. A first pass (warp_band_kernel) finds each
// item's largest clamped |dy| and |dx| (a source reaches a tap at most
// b = floor(max) + 1 rows or columns away) and its largest |g|. The block
// walks the tile's source halo, the tile +- b, one source a thread with
// coalesced loads: its coordinate, and each of its up to 4 terms
// wy * (g * wx) that lands on the tile, added to the tile's accumulator in
// shared memory. The accumulators are 64-bit integers: each term is scaled
// by 2^s, s chosen per item so that 4 (2 by + 1)(2 bx + 1) max|g| 2^s <
// 2^62 (no sum can overflow), and rounded to an integer; integer addition
// is associative, so the integer atomicAdds give the same sum in any order
// and two launches give identical bits, without float atomics. A term
// loses at most 2^-(s+1) (about 3e-16 of max|g| at R = 12); the sum is
// exact, then rounded once to f32, so it differs from the plain version's
// f32 sum by that version's own rounding. An item whose g holds an Inf or
// a NaN gets NaN. f32 arithmetic for the terms; channels two at a time.
//
// Measured first (NVIDIA H100 80GB HBM3, 700 W): a gather of the same tiles
// with the halo staged in shared memory, each warp owning two output rows
// and taking the sources that reach them in source order (a ballot, then
// one broadcast per source, or one lane per source with collisions on an
// output resolved in passes) gave the same sums in a fixed order but took
// 0.78-1.7 ms at (190,1,128,128) R=12, where this design takes 0.19 ms: the
// warp-wide votes, reductions and shuffles that each source or round cost
// bound it, not the bytes.

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

// band[3n + a] = floor(max over item n of min(|disp_a|, r)) + 1 for a = 0
// (y), 1 (x), and band[3n + 2] = the bits of max |g| over the item's c
// planes (as int: the order of non-negative floats, an Inf or a NaN above
// every finite value); band must be zero on entry. Grid (N, blocks, 3),
// whole warps (every lane reaches the shuffle).
__global__ void warp_band_kernel(const float* __restrict__ disp,
                                 const float* __restrict__ g,
                                 int* __restrict__ band, int64_t hw, int c,
                                 float r) {
  const int64_t n = blockIdx.x;
  const bool of_g = blockIdx.z == 2;
  const float* d = of_g ? g + n * c * hw : disp + (n * 2 + blockIdx.z) * hw;
  const int64_t size = of_g ? c * hw : hw;
  int b = 0;
  for (int64_t p = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; p < size;
       p += (int64_t)gridDim.y * blockDim.x) {
    const float v = fabsf(__ldg(d + p));
    // fminf drops a NaN displacement, which then takes the full band
    b = max(b, of_g ? __float_as_int(v) : (int)floorf(fminf(v, r)) + 1);
  }
  b = __reduce_max_sync(0xffffffffu, b);
  if ((threadIdx.x & 31) == 0) atomicMax(band + n * 3 + blockIdx.z, b);
}

constexpr int kChunk = 2;          // channels accumulated together
constexpr int kThreads = 256;
constexpr int kTileW = 64;
constexpr int kTileH = 32;

// acc += v for a 64-bit integer kept as two 32-bit words: an atomicAdd on
// the low word, whose old value tells the carry, then one on the high
// word. Exact mod 2^64, so the final words do not depend on the order of
// the adds. (A 64-bit atomicAdd on shared memory is a compare-and-swap loop
// on this card.)
__device__ __forceinline__ void add_fixed(unsigned* lo, unsigned* hi,
                                          long long v) {
  const unsigned vlo = (unsigned)v;
  const unsigned old = atomicAdd(lo, vlo);
  const unsigned vhi = (unsigned)((unsigned long long)v >> 32)
                       + (old + vlo < old ? 1u : 0u);
  if (vhi != 0u) atomicAdd(hi, vhi);
}

__global__ void __launch_bounds__(kThreads)
mc_warp_fused_bwd_kernel(const float* __restrict__ img,
                         const float* __restrict__ disp,
                         const float* __restrict__ g,
                         const int* __restrict__ band,
                         float* __restrict__ gimg, float* __restrict__ gdisp,
                         int n_items, int c, int h, int w, float r) {
  __shared__ unsigned s_lo[kChunk][kTileH][kTileW];
  __shared__ unsigned s_hi[kChunk][kTileH][kTileW];
  const int tid = threadIdx.x;
  const int tx0 = blockIdx.x * kTileW, ty0 = blockIdx.y * kTileH;
  const int tx1 = min(tx0 + kTileW, w) - 1;    // the tile's last column
  const int ty1 = min(ty0 + kTileH, h) - 1;    // and row
  const int64_t hw = (int64_t)h * w;
  for (int64_t n = blockIdx.z; n < n_items; n += gridDim.z) {
    if (gdisp != nullptr)                      // the tile's pixels as sources
      for (int k = tid; k < kTileH * kTileW; k += kThreads) {
        const int i = ty0 + k / kTileW, j = tx0 + k % kTileW;
        if (i <= ty1 && j <= tx1)
          disp_grad_at(img, disp, g, gdisp, n, (int64_t)i * w + j, i, j, c, h,
                       w, r);
      }

    // the source halo, rows [ry0, ry1) x columns [cx0, cx1)
    const float* dy = disp + n * 2 * hw;
    const float* dx = dy + hw;
    const int by = __ldg(band + 3 * n), bx = __ldg(band + 3 * n + 1);
    const float gmax = __int_as_float(__ldg(band + 3 * n + 2));
    const int ry0 = max(ty0 - by, 0), ry1 = min(ty1 + 1 + by, h);
    const int cx0 = max(tx0 - bx, 0), cx1 = min(tx1 + 1 + bx, w);
    // the fixed point: 4 (2 by + 1)(2 bx + 1) gmax < 2^e, terms scaled by
    // 2^s, s = 62 - e (at most 120, f32's range; then a term loses at most
    // 2^-121, far below any f32 output's tolerance)
    int e;
    frexp((double)gmax * (4.0 * (2 * by + 1) * (2 * bx + 1)), &e);
    const int shift = min(62 - e, 120);
    const float scale = ldexpf(1.0f, shift), unscale = ldexpf(1.0f, -shift);
    const bool finite = isfinite(gmax);
    for (int c0 = 0; c0 < c; c0 += kChunk) {
      const int nc = min(kChunk, c - c0);
      const float* gb = g + (n * c + c0) * hw;
      for (int k = tid; k < kChunk * kTileH * kTileW; k += kThreads) {
        (&s_lo[0][0][0])[k] = 0u;
        (&s_hi[0][0][0])[k] = 0u;
      }
      __syncthreads();
      // the halo row-major, one source a thread: consecutive threads on
      // consecutive columns
      const int halo_w = cx1 - cx0, n_src = (ry1 - ry0) * halo_w;
      for (int s = tid; s < n_src; s += kThreads) {
        const int is = ry0 + s / halo_w, js = cx0 + s % halo_w;
        const int64_t q = (int64_t)is * w + js;
        const Axis ay = axis_coord(is, __ldg(dy + q), r, h);
        if (ay.a1 < ty0 || ay.a0 > ty1) continue;   // misses the tile
        const Axis ax = axis_coord(js, __ldg(dx + q), r, w);
        if (ax.a1 < tx0 || ax.a0 > tx1) continue;
        float gv[kChunk];
#pragma unroll
        for (int ch = 0; ch < kChunk; ++ch)
          gv[ch] = ch < nc ? __ldg(gb + ch * hw + q) : 0.0f;
#pragma unroll
        for (int ty = 0; ty < 2; ++ty) {
          const int ya = ty == 0 ? ay.a0 : ay.a1;
          const float wy = ty == 0 ? 1.0f - ay.f : ay.f;
          if (ya < ty0 || ya > ty1 || wy == 0.0f) continue;
#pragma unroll
          for (int tx = 0; tx < 2; ++tx) {
            const int xa = tx == 0 ? ax.a0 : ax.a1;
            const float wx = tx == 0 ? 1.0f - ax.f : ax.f;
            if (xa < tx0 || xa > tx1 || wx == 0.0f) continue;
#pragma unroll
            for (int ch = 0; ch < kChunk; ++ch)
              if (ch < nc)
                add_fixed(&s_lo[ch][ya - ty0][xa - tx0],
                          &s_hi[ch][ya - ty0][xa - tx0],
                          __float2ll_rn((wy * (gv[ch] * wx)) * scale));
          }
        }
      }
      __syncthreads();
      for (int k = tid; k < kTileH * kTileW; k += kThreads) {
        const int i = ty0 + k / kTileW, j = tx0 + k % kTileW;
        if (i > ty1 || j > tx1) continue;
        float* out = gimg + (n * c + c0) * hw + (int64_t)i * w + j;
#pragma unroll
        for (int ch = 0; ch < kChunk; ++ch)
          if (ch < nc) {
            const int ti = k / kTileW, tj = k % kTileW;
            const long long v = (long long)(
                ((unsigned long long)s_hi[ch][ti][tj] << 32) | s_lo[ch][ti][tj]);
            out[ch * hw] = finite ? __ll2float_rn(v) * unscale
                                  : __int_as_float(0x7fffffff);
          }
      }
      __syncthreads();                         // before the next zeroing
    }
  }
}

}  // namespace

// img (N, C, H, W), disp (N, 2, H, W) [dy, dx], out (N, C, H, W); all f32,
// contiguous, on the current device. Returns cudaGetLastError().
extern "C" int mc_warp_fwd(const float* img, const float* disp, float* out,
                           int n, int c, int h, int w, int radius,
                           cudaStream_t stream) {
  if ((int64_t)n * c * h * w == 0) return (int)cudaSuccess;
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(disp) % 16 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int quads = (w + 3) / 4;
  const dim3 grid((unsigned)((quads + kFwdQuads - 1) / kFwdQuads),
                  (unsigned)((h + kFwdRows - 1) / kFwdRows),
                  (unsigned)std::min(n, 65535));
  mc_warp_fwd_kernel<<<grid, dim3(kFwdQuads, kFwdRows), 0, stream>>>(
      img, disp, out, n, c, h, w, (float)(radius - 1), vec);
  return (int)cudaGetLastError();
}

// img (N, C, H, W), disp (N, 2, H, W), g (N, C, H, W) -> gdisp (N, 2, H, W);
// all f32, contiguous, on the current device. Returns cudaGetLastError().
extern "C" int mc_warp_disp_bwd(const float* img, const float* disp,
                                const float* g, float* gdisp, int n, int c,
                                int h, int w, int radius, cudaStream_t stream) {
  if ((int64_t)n * h * w == 0) return (int)cudaSuccess;
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(disp) % 16 == 0
                   && reinterpret_cast<uintptr_t>(g) % 16 == 0
                   && reinterpret_cast<uintptr_t>(gdisp) % 16 == 0;
  const int quads = (w + 3) / 4;
  const dim3 grid((unsigned)((quads + kBwdQuads - 1) / kBwdQuads),
                  (unsigned)((h + kBwdRows - 1) / kBwdRows),
                  (unsigned)std::min(n, 65535));
  const dim3 block(kBwdQuads, kBwdRows);
  const float r = (float)(radius - 1);
  if (c == 1)
    mc_warp_disp_bwd_kernel<true><<<grid, block, 0, stream>>>(
        img, disp, g, gdisp, n, c, h, w, r, vec);
  else
    mc_warp_disp_bwd_kernel<false><<<grid, block, 0, stream>>>(
        img, disp, g, gdisp, n, c, h, w, r, vec);
  return (int)cudaGetLastError();
}

// img (N, C, H, W), disp (N, 2, H, W), g (N, C, H, W) -> gimg (N, C, H, W)
// and, unless gdisp is null, gdisp (N, 2, H, W); band is int32 scratch of
// 3N entries. All f32 (band int32), contiguous, on the current device.
// Launches warp_band_kernel, then K5. Returns cudaGetLastError().
extern "C" int mc_warp_fused_bwd(const float* img, const float* disp,
                                 const float* g, float* gimg, float* gdisp,
                                 int* band, int n, int c, int h, int w,
                                 int radius, cudaStream_t stream) {
  const int64_t hw = (int64_t)h * w;
  if ((int64_t)n * hw == 0) return (int)cudaSuccess;
  const float r = (float)(radius - 1);
  cudaError_t err = cudaMemsetAsync(band, 0, sizeof(int) * 3 * n, stream);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int64_t band_blocks = std::max<int64_t>(std::min<int64_t>(
      ((int64_t)c * hw + threads - 1) / threads, 64), 1);
  warp_band_kernel<<<dim3((unsigned)n, (unsigned)band_blocks, 3), threads, 0,
                     stream>>>(disp, g, band, hw, c, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((w + kTileW - 1) / kTileW),
                  (unsigned)((h + kTileH - 1) / kTileH),
                  (unsigned)std::min(n, 65535));
  mc_warp_fused_bwd_kernel<<<grid, kThreads, 0, stream>>>(
      img, disp, g, band, gimg, gdisp, n, c, h, w, r);
  return (int)cudaGetLastError();
}
