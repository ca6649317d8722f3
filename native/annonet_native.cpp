// annonet_jax native host runtime (C++17, plain C ABI for ctypes).
//
// Accelerator-era replacement for the host-side native code paths of the
// reference (which got them from dlib): connected-component labeling
// (dlib::label_connected_blobs call sites: /root/reference/
// annonet_train_main.cpp:450, annonet_infer.cpp:217,
// annonet_infer_main.cpp:217-218) and crop extraction with replicate /
// ignore padding (extract_image_chip + outpaint,
// annonet_train_main.cpp:160-177). The device compute path is JAX/XLA; this
// module keeps the *host* side of the pipeline native too.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libannonet_native.so
//        annonet_native.cpp   (driven by annonet_jax/native.py)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int32_t uf_find(std::vector<int32_t>& parent, int32_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];  // path halving
        x = parent[x];
    }
    return x;
}

inline void uf_union(std::vector<int32_t>& parent, int32_t a, int32_t b) {
    a = uf_find(parent, a);
    b = uf_find(parent, b);
    if (a < b) parent[b] = a; else if (b < a) parent[a] = b;
}

}  // namespace

extern "C" {

// Label equal-valued 8-connected blobs of a uint16 label image.
// Background pixels (value 0 if bg_zero, value 65535 if bg_ignore) get blob
// id 0; returns the blob count = max id + 1 (dlib convention).
// Two-pass raster union-find; single sweep over ALL values at once (the
// Python/scipy fallback loops per distinct value).
int32_t annonet_label_connected_blobs(
    const uint16_t* labels,
    int64_t h,
    int64_t w,
    int32_t bg_zero,
    int32_t bg_ignore,
    int32_t* out  // [h*w] provisional then final blob ids
) {
    const int64_t n = h * w;
    std::vector<int32_t> parent;
    parent.reserve(1024);
    parent.push_back(0);  // id 0 = background

    auto is_background = [&](uint16_t v) -> bool {
        return (bg_zero && v == 0) || (bg_ignore && v == 0xFFFF);
    };

    for (int64_t r = 0; r < h; ++r) {
        const uint16_t* row = labels + r * w;
        const uint16_t* up = row - w;
        int32_t* orow = out + r * w;
        int32_t* oup = orow - w;
        for (int64_t c = 0; c < w; ++c) {
            const uint16_t v = row[c];
            if (is_background(v)) {
                orow[c] = 0;
                continue;
            }
            int32_t label = 0;
            // scan the four already-visited 8-neighbors with equal value
            if (c > 0 && row[c - 1] == v) label = orow[c - 1];
            if (r > 0) {
                if (up[c] == v) {
                    if (label) uf_union(parent, label, oup[c]);
                    else label = oup[c];
                }
                if (c > 0 && up[c - 1] == v) {
                    if (label) uf_union(parent, label, oup[c - 1]);
                    else label = oup[c - 1];
                }
                if (c + 1 < w && up[c + 1] == v) {
                    if (label) uf_union(parent, label, oup[c + 1]);
                    else label = oup[c + 1];
                }
            }
            if (!label) {
                label = static_cast<int32_t>(parent.size());
                parent.push_back(label);
            }
            orow[c] = label;
        }
    }

    // flatten + renumber compactly (background stays 0)
    std::vector<int32_t> remap(parent.size(), 0);
    int32_t next_id = 1;
    for (size_t i = 1; i < parent.size(); ++i) {
        const int32_t root = uf_find(parent, static_cast<int32_t>(i));
        if (remap[root] == 0) remap[root] = next_id++;
        remap[i] = remap[root];
    }
    for (int64_t i = 0; i < n; ++i) {
        out[i] = remap[out[i]];
    }
    return next_id;  // count = max label + 1
}

// Extract a crop rect [top..top+crop_h) x [left..left+crop_w) from an
// (h, w, c) uint8 image with replicate padding outside the image, and from
// an (h, w) uint16 label image with IGNORE (65535) outside.
// Equivalent to extract_image_chip + outpaint + set_to_unknown_outside
// (annonet_train_main.cpp:149-179) in one pass.
void annonet_extract_crop(
    const uint8_t* image,   // [h, w, ch]
    const uint16_t* labels, // [h, w] (may be null)
    int64_t h,
    int64_t w,
    int64_t ch,
    int64_t top,
    int64_t left,
    int64_t crop_h,
    int64_t crop_w,
    uint8_t* out_image,     // [crop_h, crop_w, ch]
    uint16_t* out_labels    // [crop_h, crop_w] (may be null)
) {
    for (int64_t r = 0; r < crop_h; ++r) {
        int64_t sy = top + r;
        const bool row_outside = sy < 0 || sy >= h;
        if (sy < 0) sy = 0;
        if (sy >= h) sy = h - 1;
        const uint8_t* irow = image + sy * w * ch;
        const uint16_t* lrow = labels ? labels + sy * w : nullptr;
        uint8_t* orow = out_image + r * crop_w * ch;
        uint16_t* olrow = out_labels ? out_labels + r * crop_w : nullptr;

        // fast path: fully inside horizontally
        if (left >= 0 && left + crop_w <= w) {
            std::memcpy(orow, irow + left * ch,
                        static_cast<size_t>(crop_w * ch));
            if (olrow) {
                if (row_outside) {
                    for (int64_t c = 0; c < crop_w; ++c) olrow[c] = 0xFFFF;
                } else {
                    std::memcpy(olrow, lrow + left,
                                static_cast<size_t>(crop_w) * sizeof(uint16_t));
                }
            }
            continue;
        }
        for (int64_t c = 0; c < crop_w; ++c) {
            int64_t sx = left + c;
            const bool outside = row_outside || sx < 0 || sx >= w;
            if (sx < 0) sx = 0;
            if (sx >= w) sx = w - 1;
            std::memcpy(orow + c * ch, irow + sx * ch,
                        static_cast<size_t>(ch));
            if (olrow) olrow[c] = outside ? 0xFFFF : lrow[sx];
        }
    }
}

// Batch crop extraction with an internal thread pool: crop i reads from its
// own source image/label pair and writes slot i of the output batch arrays.
// This is the data-loader's pixel path as ONE GIL-free call per minibatch
// (the Python side only samples the crop decisions): per-crop Python/queue
// overhead disappears and the pool scales on many-core production hosts.
int32_t annonet_extract_crops_batch(
    const uint8_t* const* images,   // n pointers, each [hs[i], ws[i], ch]
    const uint16_t* const* labels,  // n pointers (entries may be null)
    const int64_t* hs,
    const int64_t* ws,
    const int64_t* tops,
    const int64_t* lefts,
    int64_t n,
    int64_t ch,
    int64_t crop_h,
    int64_t crop_w,
    uint8_t* const* out_images,   // n pointers, each [crop_h, crop_w, ch]
    uint16_t* const* out_labels,  // n pointers (entries may be null)
    int32_t thread_count
) {
    auto run = [&](int64_t begin, int64_t end) {
        for (int64_t i = begin; i < end; ++i) {
            annonet_extract_crop(
                images[i], labels ? labels[i] : nullptr, hs[i], ws[i], ch,
                tops[i], lefts[i], crop_h, crop_w,
                out_images[i],
                out_labels ? out_labels[i] : nullptr);
        }
    };
    int64_t workers = thread_count > 0 ? thread_count : 1;
    if (workers > n) workers = n;
    if (workers <= 1) {
        run(0, n);
        return 0;
    }
    std::vector<std::thread> pool;
    pool.reserve(static_cast<size_t>(workers));
    const int64_t per = (n + workers - 1) / workers;
    for (int64_t t = 0; t < workers; ++t) {
        const int64_t begin = t * per;
        const int64_t end = begin + per < n ? begin + per : n;
        if (begin >= end) break;
        pool.emplace_back(run, begin, end);
    }
    for (std::thread& t : pool) t.join();
    return 0;
}

int32_t annonet_native_abi_version() { return 1; }

}  // extern "C"

extern "C" {

// Bilinear resize of (sh, sw, ch) uint8 -> (dh, dw, ch), half-pixel centers
// with edge clamping — the native replacement for the loader's
// resize_image_bilinear (dlib::resize_image call site /root/reference/
// annonet.cpp:153). Float32 weights to match the NumPy fallback closely.
void annonet_resize_bilinear_u8(
    const uint8_t* src,
    int64_t sh,
    int64_t sw,
    int64_t ch,
    uint8_t* dst,
    int64_t dh,
    int64_t dw
) {
    std::vector<int64_t> x0(dw), x1(dw);
    std::vector<float> wx(dw);
    const double scale_x = static_cast<double>(sw) / dw;
    for (int64_t j = 0; j < dw; ++j) {
        const double xs = (j + 0.5) * scale_x - 0.5;
        int64_t f = static_cast<int64_t>(std::floor(xs));
        wx[j] = static_cast<float>(xs - f);
        x0[j] = f < 0 ? 0 : (f >= sw ? sw - 1 : f);
        int64_t g = f + 1;
        x1[j] = g < 0 ? 0 : (g >= sw ? sw - 1 : g);
    }
    const double scale_y = static_cast<double>(sh) / dh;
    for (int64_t i = 0; i < dh; ++i) {
        const double ys = (i + 0.5) * scale_y - 0.5;
        int64_t f = static_cast<int64_t>(std::floor(ys));
        const float vy = static_cast<float>(ys - f);
        const int64_t y0 = f < 0 ? 0 : (f >= sh ? sh - 1 : f);
        const int64_t y1 = (f + 1) < 0 ? 0 : ((f + 1) >= sh ? sh - 1 : f + 1);
        const uint8_t* r0 = src + y0 * sw * ch;
        const uint8_t* r1 = src + y1 * sw * ch;
        uint8_t* out = dst + i * dw * ch;
        for (int64_t j = 0; j < dw; ++j) {
            const float vx = wx[j];
            const uint8_t* a = r0 + x0[j] * ch;
            const uint8_t* b = r0 + x1[j] * ch;
            const uint8_t* c = r1 + x0[j] * ch;
            const uint8_t* d = r1 + x1[j] * ch;
            uint8_t* px = out + j * ch;
            for (int64_t k = 0; k < ch; ++k) {
                const float top = a[k] * (1.0f - vx) + b[k] * vx;
                const float bot = c[k] * (1.0f - vx) + d[k] * vx;
                float v = top * (1.0f - vy) + bot * vy;
                v = std::nearbyint(v);
                px[k] = v <= 0.0f ? 0 : (v >= 255.0f ? 255 : static_cast<uint8_t>(v));
            }
        }
    }
}

}  // extern "C"
