// Native image I/O: PNG/JPEG decode + PNG encode (C ABI for ctypes).
//
// The native replacement for the reference's dlib image I/O
// (dlib::load_image at /root/reference/annonet.cpp:150, save_png at
// annonet_infer_main.cpp:415, which wrap the same libpng/libjpeg). Used by
// the loader/writer threads with the GIL released; annonet_jax/data/sample.py
// keeps a PIL fallback behind the same interface.
//
// Channel conventions:
//   want_channels = 1  -> grayscale via ITU-R 601-2 luma with PIL's exact
//                         fixed-point rounding ((R*19595+G*38470+B*7471+0x8000)>>16)
//                         so fallbacks and native paths are bit-identical
//   want_channels = 3  -> RGB
//   want_channels = 4  -> RGBA (missing alpha filled with 255)
//
// Build: linked with -lpng -ljpeg (see native/Makefile / annonet_jax/native.py).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jump;
    int warnings;
};

void jpeg_error_exit(j_common_ptr cinfo) {
    JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->jump, 1);
}

void jpeg_emit_message(j_common_ptr cinfo, int msg_level) {
    // Corruption warnings ("Premature end of JPEG file", bogus marker
    // lengths...) are msg_level -1; libjpeg would decode anyway, filling
    // the missing area with gray. Count them so the decode can be
    // REJECTED instead: the Python layer then falls back to PIL, keeping
    // the native path's accept/reject classification identical to the
    // pure-PIL fallback (PIL raises on truncated files). Trace messages
    // (msg_level > 0) stay ignored.
    if (msg_level < 0) {
        reinterpret_cast<JpegErr*>(cinfo->err)->warnings++;
    }
}

inline uint8_t luma(uint8_t r, uint8_t g, uint8_t b) {
    // PIL Image.convert("L") fixed-point ITU-R 601-2
    return static_cast<uint8_t>(
        (r * 19595u + g * 38470u + b * 7471u + 0x8000u) >> 16);
}

// Convert an RGBA row to the wanted channel count.
void convert_row(const uint8_t* rgba, int64_t w, int want, uint8_t* out) {
    if (want == 4) {
        std::memcpy(out, rgba, static_cast<size_t>(w) * 4);
    } else if (want == 3) {
        for (int64_t i = 0; i < w; ++i) {
            out[i * 3 + 0] = rgba[i * 4 + 0];
            out[i * 3 + 1] = rgba[i * 4 + 1];
            out[i * 3 + 2] = rgba[i * 4 + 2];
        }
    } else {
        for (int64_t i = 0; i < w; ++i) {
            out[i] = luma(rgba[i * 4], rgba[i * 4 + 1], rgba[i * 4 + 2]);
        }
    }
}

// Malicious headers can declare absurd dimensions; cap what a decode may
// allocate BEFORE touching memory (an anno dataset image is far below
// this). 1<<20 px per side matches libpng's own default user limit; the
// total-pixel cap bounds the transient RGBA buffer at 1 GiB.
constexpr int64_t kMaxDim = 1 << 20;
constexpr int64_t kMaxPixels = int64_t{1} << 28;  // 256 Mpx

int32_t decode_png(FILE* f, int32_t want, uint8_t** out_data,
                   int64_t* out_h, int64_t* out_w) {
    png_structp png =
        png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) return 2;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return 2;
    }
    std::vector<uint8_t> rgba;
    std::vector<png_bytep> rows;
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return 3;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    // normalize everything to 8-bit RGBA
    png_set_expand(png);
    png_set_strip_16(png);
    png_set_gray_to_rgb(png);
    png_set_add_alpha(png, 0xFF, PNG_FILLER_AFTER);
    png_read_update_info(png, info);

    const int64_t w = png_get_image_width(png, info);
    const int64_t h = png_get_image_height(png, info);
    if (w <= 0 || h <= 0 || w > kMaxDim || h > kMaxDim ||
        h > kMaxPixels / w) {
        png_destroy_read_struct(&png, &info, nullptr);
        return 4;
    }
    if (png_get_rowbytes(png, info) != static_cast<size_t>(w) * 4) {
        png_destroy_read_struct(&png, &info, nullptr);
        return 4;
    }
    try {
        rgba.resize(static_cast<size_t>(h) * w * 4);
        rows.resize(h);
    } catch (const std::bad_alloc&) {
        // a C++ exception must not cross the extern "C"/ctypes boundary
        png_destroy_read_struct(&png, &info, nullptr);
        return 5;
    }
    for (int64_t r = 0; r < h; ++r) rows[r] = rgba.data() + r * w * 4;
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);

    uint8_t* out = static_cast<uint8_t*>(
        std::malloc(static_cast<size_t>(h) * w * want));
    if (!out) return 5;
    for (int64_t r = 0; r < h; ++r) {
        convert_row(rgba.data() + r * w * 4, w, want, out + r * w * want);
    }
    *out_data = out;
    *out_h = h;
    *out_w = w;
    return 0;
}

int32_t decode_jpeg(FILE* f, int32_t want, uint8_t** out_data,
                    int64_t* out_h, int64_t* out_w) {
    jpeg_decompress_struct cinfo;
    JpegErr err;
    // volatile: modified between setjmp and longjmp; the error path must
    // see the allocation to free it (a corrupt JPEG mid-decode would
    // otherwise leak h*w*want bytes per file)
    uint8_t* volatile out_guard = nullptr;
    uint8_t* volatile row_guard = nullptr;  // longjmp would skip vector dtors
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = jpeg_error_exit;
    err.mgr.emit_message = jpeg_emit_message;
    err.warnings = 0;
    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&cinfo);
        std::free(out_guard);
        std::free(row_guard);
        return 3;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    const int64_t w = cinfo.output_width;
    const int64_t h = cinfo.output_height;
    if (w <= 0 || h <= 0 || w > kMaxDim || h > kMaxDim ||
        h > kMaxPixels / w) {
        jpeg_destroy_decompress(&cinfo);
        return 4;
    }

    uint8_t* out = static_cast<uint8_t*>(
        std::malloc(static_cast<size_t>(h) * w * want));
    out_guard = out;
    // one scratch block: w*3 RGB row followed by w*4 RGBA row
    uint8_t* rows = static_cast<uint8_t*>(
        std::malloc(static_cast<size_t>(w) * 7));
    row_guard = rows;
    if (!out || !rows) {
        jpeg_destroy_decompress(&cinfo);
        std::free(out);
        std::free(rows);
        return 5;
    }
    uint8_t* rgb_row = rows;
    uint8_t* rgba_row = rows + static_cast<size_t>(w) * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
        // short-circuit on the FIRST corruption warning: the decode is
        // already doomed to rejection (see below), so finishing the row
        // loop — libjpeg gray-fills the rest of a truncated scan — would
        // only burn a full-image decode before the PIL-arbiter fallback
        if (err.warnings > 0) break;
        uint8_t* rowp = rgb_row;
        jpeg_read_scanlines(&cinfo, &rowp, 1);
        const int64_t r = cinfo.output_scanline - 1;
        for (int64_t i = 0; i < w; ++i) {
            rgba_row[i * 4 + 0] = rgb_row[i * 3 + 0];
            rgba_row[i * 4 + 1] = rgb_row[i * 3 + 1];
            rgba_row[i * 4 + 2] = rgb_row[i * 3 + 2];
            rgba_row[i * 4 + 3] = 0xFF;
        }
        convert_row(rgba_row, w, want, out + r * w * want);
    }
    if (err.warnings > 0) {
        // corrupt-but-decodable input: reject (see jpeg_emit_message).
        // The Python layer falls back to PIL, which ARBITRATES: benign
        // warnings (extraneous bytes before a marker) decode there and
        // the file still loads; structural damage raises there too.
        jpeg_destroy_decompress(&cinfo);  // mid-decode abort is legal
        std::free(rows);
        std::free(out);
        return 3;
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::free(rows);
    *out_data = out;
    *out_h = h;
    *out_w = w;
    return 0;
}

}  // namespace

extern "C" {

// Decode a PNG or JPEG file (sniffed by magic bytes) into want_channels
// (1/3/4) uint8 data. Returns 0 on success; *out_data is malloc'd and must
// be released with annonet_free_buffer.
int32_t annonet_decode_image(
    const char* path,
    int32_t want_channels,
    uint8_t** out_data,
    int64_t* out_h,
    int64_t* out_w
) {
    if (want_channels != 1 && want_channels != 3 && want_channels != 4) {
        return 6;
    }
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    uint8_t magic[4] = {0, 0, 0, 0};
    const size_t got = std::fread(magic, 1, 4, f);
    std::rewind(f);
    int32_t rc;
    if (got >= 4 && magic[0] == 0x89 && magic[1] == 'P' && magic[2] == 'N' &&
        magic[3] == 'G') {
        rc = decode_png(f, want_channels, out_data, out_h, out_w);
    } else if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
        rc = decode_jpeg(f, want_channels, out_data, out_h, out_w);
    } else {
        rc = 7;  // unknown format
    }
    std::fclose(f);
    return rc;
}

void annonet_free_buffer(void* p) { std::free(p); }

// Encode (h, w, 4) RGBA uint8 data as a PNG file. Returns 0 on success.
int32_t annonet_encode_png_rgba(
    const char* path,
    const uint8_t* data,
    int64_t h,
    int64_t w
) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    png_structp png =
        png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) {
        std::fclose(f);
        return 2;
    }
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_write_struct(&png, nullptr);
        std::fclose(f);
        return 2;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_write_struct(&png, &info);
        std::fclose(f);
        return 3;
    }
    png_init_io(png, f);
    png_set_IHDR(png, info, static_cast<png_uint_32>(w),
                 static_cast<png_uint_32>(h), 8, PNG_COLOR_TYPE_RGBA,
                 PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
                 PNG_FILTER_TYPE_DEFAULT);
    png_write_info(png, info);
    for (int64_t r = 0; r < h; ++r) {
        png_write_row(png, const_cast<png_bytep>(data + r * w * 4));
    }
    png_write_end(png, info);
    png_destroy_write_struct(&png, &info);
    std::fclose(f);
    return 0;
}

}  // extern "C"
