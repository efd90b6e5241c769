// PNG row reconstruction (the inverse of the five PNG filter types) —
// native core of vmap_tpu_torch/utils/png.py.
//
// Average and Paeth depend on the byte reconstructed bpp bytes before in
// the same row, so they run byte by byte; None, Sub and Up are here too so
// that one call reconstructs a whole image. The tests hold it to OpenCV's
// decoder under every filter type.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ``in``: h rows of 1 + stride bytes (the filter type, then the filtered
// bytes); ``out``: h rows of stride bytes. Returns 0, or 1 + the index of
// the first row whose filter type is not 0-4 (rows from it on are left
// unwritten). One loop a filter type, so that None, Sub and Up compile to
// plain copies and adds.
int64_t png_unfilter(const uint8_t* in, uint8_t* out, int64_t h,
                     int64_t stride, int64_t bpp) {
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t* f = in + r * (stride + 1) + 1;
        const uint8_t kind = f[-1];
        uint8_t* x = out + r * stride;
        const uint8_t* up = r ? x - stride : nullptr;   // row 0: above is 0
        const int64_t lead = bpp < stride ? bpp : stride;
        switch (kind) {
            case 0:
                std::memcpy(x, f, stride);
                break;
            case 1:
                std::memcpy(x, f, lead);
                for (int64_t i = bpp; i < stride; ++i)
                    x[i] = static_cast<uint8_t>(f[i] + x[i - bpp]);
                break;
            case 2:
                if (!up) {
                    std::memcpy(x, f, stride);
                    break;
                }
                for (int64_t i = 0; i < stride; ++i)
                    x[i] = static_cast<uint8_t>(f[i] + up[i]);
                break;
            case 3:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? x[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    x[i] = static_cast<uint8_t>(f[i] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? x[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    const int c = (up && i >= bpp) ? up[i - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = std::abs(p - a), pb = std::abs(p - b),
                              pc = std::abs(p - c);
                    const int pred = (pa <= pb && pa <= pc) ? a
                                     : (pb <= pc ? b : c);
                    x[i] = static_cast<uint8_t>(f[i] + pred);
                }
                break;
            default:
                return r + 1;
        }
    }
    return 0;
}

}  // extern "C"
