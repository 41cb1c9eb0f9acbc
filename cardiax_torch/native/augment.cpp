// Host-side data engine of cardiax_torch: affine augmentation and batch
// collation, the hot host loops of the data pipeline (rotating every mask and
// field of every augmented slice). A copy of the JAX package's engine, so the
// two packages augment bit for bit alike.
//
// Exposed through ctypes (cardiax_torch/native/lib.py):
//   rotate_nn_f32       - in-plane rotation of (H, W, T) stacks about the
//                         centre, nearest neighbour (binary masks): the
//                         skimage.rotate(order=0, reshape=False) semantics;
//   rotate_bilinear_f32 - the order-1 variant for displacement fields;
//   roll2d_f32          - np.roll translation along (y, x) of (H, W, T);
//   collate_pad_f32     - stack N same-shape f32 arrays into a batch buffer,
//                         repeating the last to pad to batch_size.
//
// Built by cardiax_torch/native/build.py with the host C++ compiler into
// cardiax_torch/_build/ (numpy/scipy semantics when there is no compiler).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Rotate each (H, W) frame of a (H, W, T) stack by angle_deg about the image
// centre. Nearest-neighbour; out-of-range samples become 0.
void rotate_nn_f32(const float* src, float* dst, int64_t h, int64_t w,
                   int64_t t, double angle_deg) {
    const double th = angle_deg * M_PI / 180.0;
    const double c = std::cos(th), s = std::sin(th);
    const double cy = (h - 1) * 0.5, cx = (w - 1) * 0.5;
    for (int64_t i = 0; i < h; ++i) {
        const double ry = i - cy;
        for (int64_t j = 0; j < w; ++j) {
            const double rx = j - cx;
            // inverse-map the output pixel into the source
            const double sy = c * ry + s * rx + cy;
            const double sx = -s * ry + c * rx + cx;
            const int64_t iy = (int64_t)std::lround(sy);
            const int64_t ix = (int64_t)std::lround(sx);
            float* drow = dst + (i * w + j) * t;
            if (iy < 0 || iy >= h || ix < 0 || ix >= w) {
                std::memset(drow, 0, sizeof(float) * (size_t)t);
            } else {
                std::memcpy(drow, src + (iy * w + ix) * t,
                            sizeof(float) * (size_t)t);
            }
        }
    }
}

// Bilinear variant (displacement fields / intensity images).
void rotate_bilinear_f32(const float* src, float* dst, int64_t h, int64_t w,
                         int64_t t, double angle_deg) {
    const double th = angle_deg * M_PI / 180.0;
    const double c = std::cos(th), s = std::sin(th);
    const double cy = (h - 1) * 0.5, cx = (w - 1) * 0.5;
    for (int64_t i = 0; i < h; ++i) {
        const double ry = i - cy;
        for (int64_t j = 0; j < w; ++j) {
            const double rx = j - cx;
            const double sy = c * ry + s * rx + cy;
            const double sx = -s * ry + c * rx + cx;
            float* drow = dst + (i * w + j) * t;
            const int64_t y0 = (int64_t)std::floor(sy);
            const int64_t x0 = (int64_t)std::floor(sx);
            if (y0 < 0 || y0 + 1 >= h || x0 < 0 || x0 + 1 >= w) {
                // border: fall back to clamped nearest (cheap, matches the
                // constant-0 outside convention closely for masks)
                const int64_t iy = (int64_t)std::lround(sy);
                const int64_t ix = (int64_t)std::lround(sx);
                if (iy < 0 || iy >= h || ix < 0 || ix >= w) {
                    std::memset(drow, 0, sizeof(float) * (size_t)t);
                } else {
                    std::memcpy(drow, src + (iy * w + ix) * t,
                                sizeof(float) * (size_t)t);
                }
                continue;
            }
            const float fy = (float)(sy - y0), fx = (float)(sx - x0);
            const float w00 = (1 - fy) * (1 - fx), w01 = (1 - fy) * fx;
            const float w10 = fy * (1 - fx), w11 = fy * fx;
            const float* p00 = src + (y0 * w + x0) * t;
            const float* p01 = src + (y0 * w + x0 + 1) * t;
            const float* p10 = src + ((y0 + 1) * w + x0) * t;
            const float* p11 = src + ((y0 + 1) * w + x0 + 1) * t;
            for (int64_t k = 0; k < t; ++k) {
                drow[k] = w00 * p00[k] + w01 * p01[k]
                        + w10 * p10[k] + w11 * p11[k];
            }
        }
    }
}

// np.roll along (y, x) of an (H, W, T) stack.
void roll2d_f32(const float* src, float* dst, int64_t h, int64_t w, int64_t t,
                int64_t shift_y, int64_t shift_x) {
    shift_y = ((shift_y % h) + h) % h;
    shift_x = ((shift_x % w) + w) % w;
    for (int64_t i = 0; i < h; ++i) {
        const int64_t si = (i - shift_y + h) % h;
        for (int64_t j = 0; j < w; ++j) {
            const int64_t sj = (j - shift_x + w) % w;
            std::memcpy(dst + (i * w + j) * t, src + (si * w + sj) * t,
                        sizeof(float) * (size_t)t);
        }
    }
}

// Stack n same-shape f32 items (given as an array of pointers) into one
// contiguous (batch_size, item_elems) buffer, repeating the last item to pad.
void collate_pad_f32(const float** items, int64_t n, int64_t item_elems,
                     int64_t batch_size, float* dst) {
    for (int64_t b = 0; b < batch_size; ++b) {
        const float* srcp = items[b < n ? b : n - 1];
        std::memcpy(dst + b * item_elems, srcp,
                    sizeof(float) * (size_t)item_elems);
    }
}

}  // extern "C"
