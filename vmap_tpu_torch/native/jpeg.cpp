// Baseline JPEG: the entropy coding, the transforms and the colour and
// resampling loops of vmap_tpu_torch/utils/jpeg.py, which parses and writes
// the markers.
//
// The arithmetic is libjpeg's (libjpeg-turbo's C code, which its SIMD
// paths reproduce bit for bit), so that a file decodes to the pixels
// OpenCV's imread gives and encodes to the bytes OpenCV's imwrite writes:
//   decode: Huffman decoding with restart markers, dequantisation, the
//     "islow" integer IDCT with its range-limit table (jidctint.c,
//     jdmaster.c), "fancy" triangle upsampling of h2v1 / h2v2 chroma
//     (jdsample.c), the fixed-point YCbCr -> RGB tables (jdcolor.c);
//   encode: the fixed-point RGB -> YCbCr tables (jccolor.c), edge
//     replication and h2v2 downsampling with the alternating 1 / 2 bias
//     (jcprepct.c, jcsample.c), the "islow" FDCT (jfdctint.c), division by
//     reciprocal (jcdctmgr.c), dummy blocks at the right and bottom edges
//     (jccoefct.c), Huffman coding with 0xFF stuffing and 1-bit padding.
// Coefficient blocks are int16 [64] in natural (row-major) order.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past 63 lands here, as libjpeg's extra entries do
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------ the islow DCT
const int CONST_BITS = 13, PASS1_BITS = 2;
const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
              F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
              F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) {
    return (x + (int64_t(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: x (masked to 10 bits) -> sample
struct RangeLimit {
    uint8_t t[1024];
    RangeLimit() {
        for (int x = 0; x < 1024; ++x) {
            int s = x < 512 ? x : x - 1024;     // the signed 10-bit value
            int v = s + 128;
            t[x] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
        }
    }
};
const RangeLimit kRange;

// jidctint.c jpeg_idct_islow: one block -> 8x8 samples at out (stride)
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int64_t stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
        int64_t z1 = (z2 + z3) * F0_541;
        int64_t tmp2 = z1 + z3 * -F1_847;
        int64_t tmp3 = z1 + z2 * F0_765;
        z2 = int64_t(ip[0]) * qp[0];
        z3 = int64_t(ip[32]) * qp[32];
        int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = int64_t(ip[56]) * qp[56];
        tmp1 = int64_t(ip[40]) * qp[40];
        tmp2 = int64_t(ip[24]) * qp[24];
        tmp3 = int64_t(ip[8]) * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * F1_175;
        tmp0 *= F0_298;
        tmp1 *= F2_053;
        tmp2 *= F3_072;
        tmp3 *= F1_501;
        z1 *= -F0_899;
        z2 *= -F2_562;
        z3 *= -F1_961;
        z4 *= -F0_390;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS - PASS1_BITS;
        ws[c + 0] = int(descale(tmp10 + tmp3, n));
        ws[c + 56] = int(descale(tmp10 - tmp3, n));
        ws[c + 8] = int(descale(tmp11 + tmp2, n));
        ws[c + 48] = int(descale(tmp11 - tmp2, n));
        ws[c + 16] = int(descale(tmp12 + tmp1, n));
        ws[c + 40] = int(descale(tmp12 - tmp1, n));
        ws[c + 24] = int(descale(tmp13 + tmp0, n));
        ws[c + 32] = int(descale(tmp13 - tmp0, n));
    }
    for (int r = 0; r < 8; ++r) {
        const int* w = ws + 8 * r;
        uint8_t* o = out + r * stride;
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * F0_541;
        int64_t tmp2 = z1 + z3 * -F1_847;
        int64_t tmp3 = z1 + z2 * F0_765;
        int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CONST_BITS);
        int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * F1_175;
        tmp0 *= F0_298;
        tmp1 *= F2_053;
        tmp2 *= F3_072;
        tmp3 *= F1_501;
        z1 *= -F0_899;
        z2 *= -F2_562;
        z3 *= -F1_961;
        z4 *= -F0_390;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS + PASS1_BITS + 3;
        auto lim = [](int64_t x) { return kRange.t[int(x) & 1023]; };
        o[0] = lim(descale(tmp10 + tmp3, n));
        o[7] = lim(descale(tmp10 - tmp3, n));
        o[1] = lim(descale(tmp11 + tmp2, n));
        o[6] = lim(descale(tmp11 - tmp2, n));
        o[2] = lim(descale(tmp12 + tmp1, n));
        o[5] = lim(descale(tmp12 - tmp1, n));
        o[3] = lim(descale(tmp13 + tmp0, n));
        o[4] = lim(descale(tmp13 - tmp0, n));
    }
}

// jfdctint.c jpeg_fdct_islow on level-shifted samples, in place (results
// scaled up by 8)
void fdct_islow(int32_t* d) {
    for (int r = 0; r < 8; ++r) {
        int32_t* p = d + 8 * r;
        int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
        int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
        int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
        int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = int32_t((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4] = int32_t((tmp10 - tmp11) * (1 << PASS1_BITS));
        int64_t z1 = (tmp12 + tmp13) * F0_541;
        const int n = CONST_BITS - PASS1_BITS;
        p[2] = int32_t(descale(z1 + tmp13 * F0_765, n));
        p[6] = int32_t(descale(z1 + tmp12 * -F1_847, n));
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int64_t z5 = (z3 + z4) * F1_175;
        tmp4 *= F0_298;
        tmp5 *= F2_053;
        tmp6 *= F3_072;
        tmp7 *= F1_501;
        z1 *= -F0_899;
        z2 *= -F2_562;
        z3 *= -F1_961;
        z4 *= -F0_390;
        z3 += z5;
        z4 += z5;
        p[7] = int32_t(descale(tmp4 + z1 + z3, n));
        p[5] = int32_t(descale(tmp5 + z2 + z4, n));
        p[3] = int32_t(descale(tmp6 + z2 + z3, n));
        p[1] = int32_t(descale(tmp7 + z1 + z4, n));
    }
    for (int c = 0; c < 8; ++c) {
        int32_t* p = d + c;
        int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
        int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
        int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
        int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = int32_t(descale(tmp10 + tmp11, PASS1_BITS));
        p[32] = int32_t(descale(tmp10 - tmp11, PASS1_BITS));
        int64_t z1 = (tmp12 + tmp13) * F0_541;
        const int n = CONST_BITS + PASS1_BITS;
        p[16] = int32_t(descale(z1 + tmp13 * F0_765, n));
        p[48] = int32_t(descale(z1 + tmp12 * -F1_847, n));
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int64_t z5 = (z3 + z4) * F1_175;
        tmp4 *= F0_298;
        tmp5 *= F2_053;
        tmp6 *= F3_072;
        tmp7 *= F1_501;
        z1 *= -F0_899;
        z2 *= -F2_562;
        z3 *= -F1_961;
        z4 *= -F0_390;
        z3 += z5;
        z4 += z5;
        p[56] = int32_t(descale(tmp4 + z1 + z3, n));
        p[40] = int32_t(descale(tmp5 + z2 + z4, n));
        p[24] = int32_t(descale(tmp6 + z2 + z3, n));
        p[8] = int32_t(descale(tmp7 + z1 + z4, n));
    }
}

// jcdctmgr.c compute_reciprocal / quantize (16-bit DCTELEM): divides by
// ``divisor`` = 8 x the quantisation value, rounding half away from 0
struct Divisor {
    uint32_t recip, corr;
    int shift;
    explicit Divisor(uint32_t divisor = 8) {
        int b = 31 - __builtin_clz(divisor);
        int r = 16 + b;
        uint32_t fq = (uint32_t(1) << r) / divisor;
        uint32_t fr = (uint32_t(1) << r) % divisor;
        uint32_t c = divisor / 2;
        if (fr == 0) {
            fq >>= 1;
            --r;
        } else if (fr <= divisor / 2) {
            ++c;
        } else {
            ++fq;
        }
        recip = fq;
        corr = c;
        shift = r;
    }
    int16_t apply(int32_t x) const {
        uint32_t a = uint32_t(x < 0 ? -x : x);
        int32_t q = int32_t(((a + corr) * recip) >> shift);
        return int16_t(x < 0 ? -q : q);
    }
};

// ------------------------------------------------------------ Huffman
struct DecTable {
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    // 9-bit lookahead: (length << 8) | value, 0 where the code is longer
    uint16_t look[512];
    bool ok;
};

void build_dec(const uint8_t* bits, const uint8_t* vals, DecTable* t) {
    std::memcpy(t->vals, vals, 256);
    std::memset(t->look, 0, sizeof(t->look));
    int code = 0, k = 0;
    t->ok = true;
    for (int l = 1; l <= 16; ++l) {
        int n = bits[l - 1];
        t->valoffset[l] = k - code;
        // more codes than fit in l bits, or more than 256 values: refused
        // before any entry is written
        if (code + n > (1 << l) || k + n > 256) {
            t->ok = false;
            return;
        }
        if (n) {
            for (int i = 0; i < n; ++i, ++k, ++code) {
                if (l <= 9) {
                    int shift = 9 - l;
                    for (int j = 0; j < (1 << shift); ++j)
                        t->look[(code << shift) | j] =
                            uint16_t((l << 8) | vals[k]);
                }
            }
            t->maxcode[l] = code - 1;
        } else {
            t->maxcode[l] = -1;
        }
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;   // sentinel: a bad code ends at 17 bits
}

struct BitReader {
    const uint8_t* data;
    int64_t len, pos;
    uint64_t buf = 0;
    int nbits = 0;
    bool marker = false;   // a marker was reached: feed zeros from here

    void fill() {
        while (nbits <= 56) {
            uint8_t b = 0;
            if (!marker) {
                if (pos >= len) {
                    marker = true;
                } else if (data[pos] == 0xFF) {
                    if (pos + 1 < len && data[pos + 1] == 0) {
                        b = 0xFF;
                        pos += 2;
                    } else {
                        marker = true;
                    }
                } else {
                    b = data[pos++];
                }
            }
            buf |= uint64_t(b) << (56 - nbits);
            nbits += 8;
        }
    }
    int peek(int n) {
        if (nbits < n) fill();
        return int(buf >> (64 - n));
    }
    void skip(int n) {
        buf <<= n;
        nbits -= n;
    }
    int get(int n) {
        if (n == 0) return 0;
        int v = peek(n);
        skip(n);
        return v;
    }
    int decode(const DecTable& t) {
        int p = peek(16);
        int e = t.look[p >> 7];
        if (e) {
            skip(e >> 8);
            return e & 0xFF;
        }
        int l = 10;
        while (l <= 16 && (p >> (16 - l)) > t.maxcode[l]) ++l;
        if (l > 16) return -1;
        int code = p >> (16 - l);
        skip(l);
        return t.vals[(t.valoffset[l] + code) & 0xFF];
    }
    // the restart marker RSTn after an interval: drop the padding bits,
    // step over fill bytes to the marker and past it
    bool restart() {
        buf = 0;
        nbits = 0;
        marker = false;
        while (pos + 1 < len) {
            if (data[pos] == 0xFF && data[pos + 1] >= 0xD0 &&
                data[pos + 1] <= 0xD7) {
                pos += 2;
                return true;
            }
            ++pos;
        }
        return false;
    }
};

inline int extend(int v, int n) {
    return v < (1 << (n - 1)) ? v - (1 << n) + 1 : v;
}

struct EncTable {
    uint16_t code[256];
    uint8_t size[256];
};

void build_enc(const uint8_t* bits, const uint8_t* vals, EncTable* t) {
    std::memset(t->size, 0, sizeof(t->size));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
            t->code[vals[k]] = uint16_t(code);
            t->size[vals[k]] = uint8_t(l);
        }
        code <<= 1;
    }
}

struct BitWriter {
    uint8_t* out;
    int64_t cap, n = 0;
    uint64_t buf = 0;
    int nbits = 0;
    bool overflow = false;

    void byte(uint8_t b) {
        if (n + 2 > cap) {
            overflow = true;
            return;
        }
        out[n++] = b;
        if (b == 0xFF) out[n++] = 0;
    }
    void put(uint32_t v, int size) {
        if (!size) return;
        buf = (buf << size) | (v & ((uint32_t(1) << size) - 1));
        nbits += size;
        while (nbits >= 8) {
            nbits -= 8;
            byte(uint8_t(buf >> nbits));
        }
    }
    void flush() {   // pad with 1 bits
        if (nbits) put(0x7F, 8 - nbits);
    }
};

inline int nbits_of(int v) {
    int n = 0;
    while (v) {
        ++n;
        v >>= 1;
    }
    return n;
}

void encode_block(BitWriter& w, const int16_t* blk, int& last_dc,
                  const EncTable& dc, const EncTable& ac) {
    int t = blk[0] - last_dc, t2 = t;
    last_dc = blk[0];
    if (t < 0) {
        t = -t;
        --t2;
    }
    int nb = nbits_of(t);
    w.put(dc.code[nb], dc.size[nb]);
    w.put(uint32_t(t2), nb);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
        int v = blk[kNatural[k]];
        if (v == 0) {
            ++run;
            continue;
        }
        while (run > 15) {
            w.put(ac.code[0xF0], ac.size[0xF0]);
            run -= 16;
        }
        int a = v, a2 = v;
        if (a < 0) {
            a = -a;
            --a2;
        }
        nb = nbits_of(a);
        int sym = (run << 4) + nb;
        w.put(ac.code[sym], ac.size[sym]);
        w.put(uint32_t(a2), nb);
        run = 0;
    }
    if (run > 0) w.put(ac.code[0], ac.size[0]);
}

}  // namespace

extern "C" {

// One Huffman-coded scan of a sequential JPEG, starting at ``pos``, into
// coefficient planes. ``comp``: per scan component, 6 int32: h and v
// blocks per MCU (1 x 1 in a one-component scan), DC and AC table index,
// the plane's blocks per row and rows; ``off``: each plane's offset, in
// blocks, into ``coef``. ``huff``: 8 tables (DC 0-3, AC 0-3) of 16 code
// counts then 256 values. Returns the position after the scan's data (at
// the next marker), or -1 for a corrupt code or -2 for a bad table.
int64_t jpeg_decode_scan(const uint8_t* data, int64_t len, int64_t pos,
                         int32_t ncomp, const int32_t* comp,
                         const int64_t* off, const uint8_t* huff,
                         int32_t restart_interval, int32_t mcux,
                         int32_t mcuy, int16_t* coef) {
    DecTable tabs[8];
    for (int i = 0; i < 8; ++i) {
        build_dec(huff + i * 272, huff + i * 272 + 16, &tabs[i]);
    }
    for (int c = 0; c < ncomp; ++c) {
        if (!tabs[comp[6 * c + 2]].ok || !tabs[4 + comp[6 * c + 3]].ok)
            return -2;
    }
    BitReader br{data, len, pos};
    int pred[4] = {0, 0, 0, 0};
    int64_t n_mcu = int64_t(mcux) * mcuy, todo = restart_interval;
    for (int64_t m = 0; m < n_mcu; ++m) {
        if (restart_interval) {
            if (todo == 0) {
                if (!br.restart()) return -1;
                std::memset(pred, 0, sizeof(pred));
                todo = restart_interval;
            }
            --todo;
        }
        int64_t mx = m % mcux, my = m / mcux;
        for (int c = 0; c < ncomp; ++c) {
            const int32_t* p = comp + 6 * c;
            const DecTable& dc = tabs[p[2]];
            const DecTable& ac = tabs[4 + p[3]];
            for (int by = 0; by < p[1]; ++by) {
                for (int bx = 0; bx < p[0]; ++bx) {
                    int64_t row = my * p[1] + by, col = mx * p[0] + bx;
                    int16_t* blk = coef + (off[c] + row * p[4] + col) * 64;
                    std::memset(blk, 0, 64 * sizeof(int16_t));
                    int s = br.decode(dc);
                    if (s < 0 || s > 15) return -1;
                    pred[c] += s ? extend(br.get(s), s) : 0;
                    blk[0] = int16_t(pred[c]);
                    for (int k = 1; k < 64;) {
                        int rs = br.decode(ac);
                        if (rs < 0) return -1;
                        int r = rs >> 4, sz = rs & 15;
                        if (sz) {
                            k += r;
                            int v = extend(br.get(sz), sz);
                            blk[kNatural[k]] = int16_t(v);
                            ++k;
                        } else {
                            if (r != 15) break;
                            k += 16;
                        }
                    }
                }
            }
        }
    }
    // the position of the marker that ends the scan
    int64_t end = br.pos;
    while (end + 1 < len &&
           !(data[end] == 0xFF && data[end + 1] != 0 &&
             !(data[end + 1] >= 0xD0 && data[end + 1] <= 0xD7) &&
             data[end + 1] != 0xFF))
        ++end;
    return end;
}

// IDCT of a plane of bw x bh blocks (``q``: the quantisation table in
// natural order) into bh*8 rows of bw*8 samples.
void jpeg_idct_plane(const int16_t* coef, int32_t bw, int32_t bh,
                     const uint16_t* q, uint8_t* out) {
    const int64_t stride = int64_t(bw) * 8;
    for (int64_t r = 0; r < bh; ++r)
        for (int64_t c = 0; c < bw; ++c)
            idct_islow(coef + (r * bw + c) * 64, q, out + r * 8 * stride + c * 8,
                       stride);
}

// jdsample.c: a component of dw x dh samples (row stride ``in_stride``)
// upsampled by hf x vf (1 or 2 each; h1v2 is refused by the caller) into
// out_h rows of out_w samples. h2v1 / h2v2 are "fancy" (triangle) where
// dw > 2, box otherwise; rows above the first and below the last repeat
// them, as libjpeg's context rows do.
void jpeg_upsample(const uint8_t* in, int64_t in_stride, int32_t dw,
                   int32_t dh, int32_t hf, int32_t vf, uint8_t* out,
                   int32_t out_w, int32_t out_h) {
    uint8_t* row = static_cast<uint8_t*>(std::malloc(size_t(dw) * 2 + 2));
    for (int32_t y = 0; y < out_h; ++y) {
        int32_t iy = vf == 2 ? y / 2 : y;
        if (iy > dh - 1) iy = dh - 1;
        const uint8_t* r0 = in + int64_t(iy) * in_stride;
        uint8_t* o = out + int64_t(y) * out_w;
        if (hf == 1 && vf == 1) {
            std::memcpy(o, r0, size_t(out_w));
            continue;
        }
        if (dw <= 2) {   // box
            for (int32_t x = 0; x < out_w; ++x) o[x] = r0[hf == 2 ? x / 2 : x];
            continue;
        }
        if (vf == 1) {   // h2v1_fancy_upsample
            row[0] = r0[0];
            row[1] = uint8_t((r0[0] * 3 + r0[1] + 2) >> 2);
            for (int32_t c = 1; c < dw - 1; ++c) {
                int v = r0[c] * 3;
                row[2 * c] = uint8_t((v + r0[c - 1] + 1) >> 2);
                row[2 * c + 1] = uint8_t((v + r0[c + 1] + 2) >> 2);
            }
            row[2 * dw - 2] = uint8_t((r0[dw - 1] * 3 + r0[dw - 2] + 1) >> 2);
            row[2 * dw - 1] = r0[dw - 1];
        } else {         // h2v2_fancy_upsample
            int32_t jy = (y & 1) ? iy + 1 : iy - 1;   // the next nearest row
            if (jy < 0) jy = 0;
            if (jy > dh - 1) jy = dh - 1;
            const uint8_t* r1 = in + int64_t(jy) * in_stride;
            int this_ = r0[0] * 3 + r1[0], next = r0[1] * 3 + r1[1], last;
            row[0] = uint8_t((this_ * 4 + 8) >> 4);
            row[1] = uint8_t((this_ * 3 + next + 7) >> 4);
            last = this_;
            this_ = next;
            for (int32_t c = 1; c < dw - 1; ++c) {
                next = r0[c + 1] * 3 + r1[c + 1];
                row[2 * c] = uint8_t((this_ * 3 + last + 8) >> 4);
                row[2 * c + 1] = uint8_t((this_ * 3 + next + 7) >> 4);
                last = this_;
                this_ = next;
            }
            row[2 * dw - 2] = uint8_t((this_ * 3 + last + 8) >> 4);
            row[2 * dw - 1] = uint8_t((this_ * 4 + 7) >> 4);
        }
        std::memcpy(o, row, size_t(out_w));
    }
    std::free(row);
}

// jdcolor.c ycc_rgb_convert: three w x h planes -> [h, w, 3] RGB
void jpeg_ycc_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                  int64_t n, uint8_t* out) {
    static int cr_r[256], cb_b[256];
    static int64_t cr_g[256], cb_g[256];
    static bool ready = false;
    if (!ready) {
        const int64_t half = int64_t(1) << 15;
        for (int i = 0; i < 256; ++i) {
            int64_t x = i - 128;
            cr_r[i] = int((int64_t(91881) * x + half) >> 16);    // 1.40200
            cb_b[i] = int((int64_t(116130) * x + half) >> 16);   // 1.77200
            cr_g[i] = -int64_t(46802) * x;                       // 0.71414
            cb_g[i] = -int64_t(22554) * x + half;                // 0.34414
        }
        ready = true;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int64_t i = 0; i < n; ++i) {
        int Y = y[i], Cb = cb[i], Cr = cr[i];
        out[3 * i] = clamp(Y + cr_r[Cr]);
        out[3 * i + 1] = clamp(Y + int((cb_g[Cb] + cr_g[Cr]) >> 16));
        out[3 * i + 2] = clamp(Y + cb_b[Cb]);
    }
}

// RGB [h, w, 3] -> the Huffman-coded scan of a baseline 4:2:0 JPEG, as
// libjpeg's defaults code it (one interleaved scan, no restarts): ``qy``
// / ``qc`` the luma / chroma quantisation tables in natural order,
// ``huff`` 4 tables (luma DC, luma AC, chroma DC, chroma AC) of 16 code
// counts then 256 values. Returns the bytes written to ``out`` (its
// final byte padded with 1 bits), or -1 if ``cap`` was too small.
int64_t jpeg_encode_420(const uint8_t* rgb, int32_t w, int32_t h,
                        const uint16_t* qy, const uint16_t* qc,
                        const uint8_t* huff, uint8_t* out, int64_t cap) {
    const int64_t FIXR_Y = 19595, FIXG_Y = 38470, FIXB_Y = 7471;
    const int64_t FIXR_CB = 11059, FIXG_CB = 21709, FIX_HALF = 32768;
    const int64_t FIXG_CR = 27439, FIXB_CR = 5329;
    const int64_t ONE_HALF = int64_t(1) << 15, CBCR_OFF = int64_t(128) << 16;
    const int32_t mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
    const int32_t ybw = (w + 7) / 8, ybh = (h + 7) / 8;   // luma blocks
    const int32_t cw = mcux * 8, ch = mcuy * 8;           // chroma samples
    const int32_t pw = mcux * 16, ph = mcuy * 16;         // padded luma
    // colour conversion over the image, edges replicated to whole MCUs
    uint8_t* Y = static_cast<uint8_t*>(std::malloc(size_t(pw) * ph));
    uint8_t* Cb = static_cast<uint8_t*>(std::malloc(size_t(pw) * ph));
    uint8_t* Cr = static_cast<uint8_t*>(std::malloc(size_t(pw) * ph));
    for (int32_t r = 0; r < ph; ++r) {
        const uint8_t* src = rgb + int64_t(r < h ? r : h - 1) * w * 3;
        for (int32_t c = 0; c < pw; ++c) {
            const uint8_t* px = src + int64_t(c < w ? c : w - 1) * 3;
            int64_t R = px[0], G = px[1], B = px[2];
            int64_t i = int64_t(r) * pw + c;
            Y[i] = uint8_t((FIXR_Y * R + FIXG_Y * G + FIXB_Y * B + ONE_HALF)
                           >> 16);
            Cb[i] = uint8_t((-FIXR_CB * R - FIXG_CB * G + FIX_HALF * B +
                             CBCR_OFF + ONE_HALF - 1) >> 16);
            Cr[i] = uint8_t((FIX_HALF * R - FIXG_CR * G - FIXB_CR * B +
                             CBCR_OFF + ONE_HALF - 1) >> 16);
        }
    }
    // h2v2 downsampling (bias 1, 2, 1, 2, ... along each output row)
    uint8_t* dcb = static_cast<uint8_t*>(std::malloc(size_t(cw) * ch));
    uint8_t* dcr = static_cast<uint8_t*>(std::malloc(size_t(cw) * ch));
    for (int32_t r = 0; r < ch; ++r) {
        for (int32_t c = 0; c < cw; ++c) {
            int bias = (c & 1) ? 2 : 1;
            int64_t a = int64_t(2 * r) * pw + 2 * c, b = a + pw;
            dcb[int64_t(r) * cw + c] =
                uint8_t((Cb[a] + Cb[a + 1] + Cb[b] + Cb[b + 1] + bias) >> 2);
            dcr[int64_t(r) * cw + c] =
                uint8_t((Cr[a] + Cr[a + 1] + Cr[b] + Cr[b + 1] + bias) >> 2);
        }
    }
    // the chroma rows below the last one downsampled from the image
    // repeat it (jcprepct.c expand_bottom_edge)
    const int32_t crows = (h + 1) / 2;
    for (int32_t r = crows; r < ch; ++r) {
        std::memcpy(dcb + int64_t(r) * cw, dcb + int64_t(crows - 1) * cw, cw);
        std::memcpy(dcr + int64_t(r) * cw, dcr + int64_t(crows - 1) * cw, cw);
    }
    std::free(Cb);
    std::free(Cr);

    Divisor dy[64], dc[64];
    for (int i = 0; i < 64; ++i) {
        dy[i] = Divisor(uint32_t(qy[i]) << 3);
        dc[i] = Divisor(uint32_t(qc[i]) << 3);
    }
    EncTable t[4];
    for (int i = 0; i < 4; ++i) build_enc(huff + i * 272, huff + i * 272 + 16,
                                          &t[i]);
    auto block = [](const uint8_t* plane, int32_t stride, int32_t bx,
                    int32_t by, const Divisor* d, int16_t* blk) {
        int32_t ws[64];
        for (int r = 0; r < 8; ++r)
            for (int c = 0; c < 8; ++c)
                ws[r * 8 + c] =
                    int32_t(plane[int64_t(by * 8 + r) * stride + bx * 8 + c]) -
                    128;
        fdct_islow(ws);
        for (int i = 0; i < 64; ++i) blk[i] = d[i].apply(ws[i]);
    };
    BitWriter bw{out, cap};
    int last[3] = {0, 0, 0};
    int16_t blk[4][64], cblk[64];
    for (int32_t my = 0; my < mcuy; ++my) {
        for (int32_t mx = 0; mx < mcux; ++mx) {
            // luma: 2 x 2 blocks; those past the image's blocks are
            // dummies, their DC the previous block's (jccoefct.c)
            for (int by = 0; by < 2; ++by) {
                int32_t row = my * 2 + by;
                for (int bx = 0; bx < 2; ++bx) {
                    int16_t* b = blk[by * 2 + bx];
                    int32_t col = mx * 2 + bx;
                    if (row < ybh && col < ybw) {
                        block(Y, pw, col, row, dy, b);
                    } else {
                        std::memset(b, 0, sizeof(blk[0]));
                        const int16_t* prev =
                            row < ybh ? blk[by * 2 + bx - 1] : blk[by * 2 - 1];
                        b[0] = prev[0];
                    }
                }
            }
            for (int i = 0; i < 4; ++i)
                encode_block(bw, blk[i], last[0], t[0], t[1]);
            block(dcb, cw, mx, my, dc, cblk);
            encode_block(bw, cblk, last[1], t[2], t[3]);
            block(dcr, cw, mx, my, dc, cblk);
            encode_block(bw, cblk, last[2], t[2], t[3]);
        }
    }
    bw.flush();
    std::free(Y);
    std::free(dcb);
    std::free(dcr);
    return bw.overflow ? -1 : bw.n;
}

}  // extern "C"
