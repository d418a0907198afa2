// Native host-side preprocessing kernels for fastdepth_tpu_torch: the
// port's copy of the JAX package's csrc/preprocess.cpp.
//
// Replacement for the reference's per-item PIL/scipy transform
// chain (reference dataloaders/transforms.py; hot spot per SURVEY.md §3.2):
// the fused val-pipeline geometry is a (row, col) gather pair
// (data/pipeline.py), and these kernels execute that gather
// + dtype conversion at memcpy-like speed with no Python object overhead,
// releasing the GIL for the loader's thread pool.
//
// Build: at first use, by ops/cuda/_build.py::build_native (g++ with
// -ffp-contract=off) into _build/ (loaded via ctypes, data/native.py;
// numpy fallback when no g++ is found).

#include <cstdint>
#include <cstring>

namespace {

// u8 -> [0,1] f32 lookup table.  Function-local static of a class type:
// C++11 guarantees thread-safe one-time construction, so concurrent calls
// from the loader's thread pool are race-free (a hand-rolled bool flag
// would not be).
struct U8ToUnitF32 {
    float v[256];
    U8ToUnitF32() {
        for (int i = 0; i < 256; ++i) v[i] = static_cast<float>(i) / 255.0f;
    }
};

const float* unit_lut() {
    static const U8ToUnitF32 lut;
    return lut.v;
}

}  // namespace

extern "C" {

// ABI version handshake: the Python loader refuses a stale build whose
// version doesn't match (the .so is NOT version-controlled; it is built
// at first use).  Bump when any signature below changes.
int64_t fd_abi_version() { return 4; }

// rgb uint8 HWC -> gathered float32 HWC in [0, 1]
// dst[oh, ow, c] = src[rows[oh], cols[ow], c] / 255
void fd_gather_rgb_f32(const uint8_t* src, int64_t src_h, int64_t src_w,
                       const int64_t* rows, const int64_t* cols,
                       int64_t out_h, int64_t out_w, float* dst) {
    const float* lut = unit_lut();
    for (int64_t oh = 0; oh < out_h; ++oh) {
        const uint8_t* row = src + rows[oh] * src_w * 3;
        float* out = dst + oh * out_w * 3;
        for (int64_t ow = 0; ow < out_w; ++ow) {
            const uint8_t* px = row + cols[ow] * 3;
            out[ow * 3 + 0] = lut[px[0]];
            out[ow * 3 + 1] = lut[px[1]];
            out[ow * 3 + 2] = lut[px[2]];
        }
    }
}

// depth float32 HW -> gathered float32 HW
void fd_gather_depth_f32(const float* src, int64_t src_h, int64_t src_w,
                         const int64_t* rows, const int64_t* cols,
                         int64_t out_h, int64_t out_w, float* dst) {
    for (int64_t oh = 0; oh < out_h; ++oh) {
        const float* row = src + rows[oh] * src_w;
        float* out = dst + oh * out_w;
        for (int64_t ow = 0; ow < out_w; ++ow) {
            out[ow] = row[cols[ow]];
        }
    }
}

// CHW uint8 -> HWC uint8 (the h5 'rgb' key layout transpose,
// reference dataloaders/dataloader.py:8-13)
void fd_chw_to_hwc_u8(const uint8_t* src, int64_t h, int64_t w, uint8_t* dst) {
    const int64_t plane = h * w;
    for (int64_t y = 0; y < h; ++y) {
        for (int64_t x = 0; x < w; ++x) {
            const int64_t idx = y * w + x;
            uint8_t* out = dst + idx * 3;
            out[0] = src[idx];
            out[1] = src[plane + idx];
            out[2] = src[2 * plane + idx];
        }
    }
}

// ---------------------------------------------------------------------------
// Train-item kernels (reference dataloaders/nyu.py:26-46): the whole
// composed geometry (first resize -> rotate -> scale resize -> crop ->
// flip -> final resize, data/pipeline.py::composed_indices) is ONE flat
// raw->output gather plus the rotation's zero-pad mask; color jitter is
// PIL ImageEnhance arithmetic, replicated bit-exactly (the blend is a
// float32 truncate-then-clip, the 'L' plane the fixed-point dot —
// sweep-verified against Pillow itself in tests/test_native.py).  All
// entry points are plain-C over caller-owned buffers, so the ctypes
// layer releases the GIL for the loader's worker threads.

// PIL convert('L'): (R*19595 + G*38470 + B*7471 + 0x8000) >> 16
static inline int32_t pil_l(const uint8_t* px) {
    return static_cast<int32_t>(
        (px[0] * 19595 + px[1] * 38470 + px[2] * 7471 + 0x8000) >> 16);
}

// PIL Image.blend: float32 in1 + a*(in2 - in1), C-cast truncation, clip.
static inline uint8_t pil_blend(float in1, float in2, float alpha) {
    const float t = in1 + alpha * (in2 - in1);
    if (t <= 0.0f) return 0;
    if (t >= 255.0f) return 255;
    return static_cast<uint8_t>(t);
}

// Fused composed gather + rotation pad mask (the dominant per-item
// memory op): rgb_raw is the flattened (raw_h*raw_w, 3) uint8 image,
// depth_raw the flattened float32 plane; flat[i] indexes the raw plane,
// mask[i] != 0 marks the rotation's constant-pad region (-> 0).  Depth
// also divides by the draw's scale s (reference nyu.py:28, depth /= s) —
// a DIVISION, not a reciprocal multiply, so the result is bit-identical
// to the numpy fallback's float32 `gathered / s`.
void fd_train_gather(const uint8_t* rgb_raw, const float* depth_raw,
                     const int64_t* flat, const uint8_t* mask, int64_t n,
                     float scale, uint8_t* rgb_out, float* depth_out) {
    for (int64_t i = 0; i < n; ++i) {
        if (mask[i]) {
            rgb_out[i * 3 + 0] = 0;
            rgb_out[i * 3 + 1] = 0;
            rgb_out[i * 3 + 2] = 0;
            depth_out[i] = 0.0f;
        } else {
            const uint8_t* px = rgb_raw + flat[i] * 3;
            rgb_out[i * 3 + 0] = px[0];
            rgb_out[i * 3 + 1] = px[1];
            rgb_out[i * 3 + 2] = px[2];
            depth_out[i] = depth_raw[flat[i]] / scale;
        }
    }
}

// 256-entry value-map apply (brightness/contrast enhance: the LUT
// itself is built BY Pillow on the Python side, transforms.py
// _blend_lut, so its arithmetic is PIL's by construction).  dst may
// alias src for in-place use.
void fd_lut_u8(const uint8_t* src, int64_t nbytes, const uint8_t* lut,
               uint8_t* dst) {
    for (int64_t i = 0; i < nbytes; ++i) dst[i] = lut[src[i]];
}

// Sum of the PIL 'L' plane over an (n, 3) RGB image — the contrast
// enhance's degenerate gray is int(mean(L) + 0.5) (ImageEnhance.Contrast);
// the mean stays exact in the caller's float64 for any image size.
int64_t fd_l_sum(const uint8_t* img, int64_t n) {
    int64_t s = 0;
    for (int64_t i = 0; i < n; ++i) s += pil_l(img + i * 3);
    return s;
}

// PIL ImageEnhance.Color (saturation): blend each pixel with its own
// 'L' gray — the degenerate is per-pixel, so unlike brightness/contrast
// this cannot be a 1-D LUT.  dst may alias src.
void fd_blend_gray_u8(const uint8_t* src, int64_t n, float factor,
                      uint8_t* dst) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* px = src + i * 3;
        uint8_t* out = dst + i * 3;
        const float g = static_cast<float>(pil_l(px));
        out[0] = pil_blend(g, static_cast<float>(px[0]), factor);
        out[1] = pil_blend(g, static_cast<float>(px[1]), factor);
        out[2] = pil_blend(g, static_cast<float>(px[2]), factor);
    }
}

// Whole-op enhance value grid for the DEVICE jitter path:
// out[d*256 + v] = pil_blend(d, v, factor) — one (256, 256) uint8 map
// per jitter op (transforms.blend_grid's arithmetic; the device then
// only row-selects by integer grays, data/device_aug.py).  Baked here
// because the per-item numpy bake (~0.27 ms/grid on this host) was the
// single largest cost of device-augment item assembly.
void fd_blend_grid(float factor, uint8_t* out) {
    for (int32_t d = 0; d < 256; ++d) {
        const float df = static_cast<float>(d);
        uint8_t* row = out + d * 256;
        for (int32_t v = 0; v < 256; ++v)
            row[v] = pil_blend(df, static_cast<float>(v), factor);
    }
}

// u8 -> [0,1] f32 (the final /255, reference nyu.py:43)
void fd_u8_to_unit_f32(const uint8_t* img, int64_t nbytes, float* dst) {
    const float* lut = unit_lut();
    for (int64_t i = 0; i < nbytes; ++i) dst[i] = lut[img[i]];
}

}  // extern "C"
