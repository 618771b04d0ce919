/* Baseline JPEG decoding on the host, bit for bit as libjpeg(-turbo)'s
   default decompression gives it (what cv2.imread and PIL read with).

   What it decodes: sequential DCT with Huffman coding (SOF0, and SOF1 at
   8 bits), interleaved or one scan per component, restart markers, 8- or
   16-bit quantisation tables; one component (gray) or three (YCbCr, or RGB
   when an Adobe marker says transform 0 or the component ids are 'R', 'G',
   'B'). The stages are libjpeg's defaults:
     - the inverse DCT is jidctint.c's ISLOW (integer, 13-bit constants,
       two passes, the post-IDCT range-limit table);
     - chroma is upsampled as jdsample.c's "fancy" filters do: the
       triangle filter for 2h1v (4:2:2) and 2h2v (4:2:0) with its
       alternating rounding biases (1/2 and 8/7), 1h2v (4:4:0) likewise,
       the top and bottom rows and the edge columns of each component
       replicated; box replication for other integral factors and for
       components narrower than 3 samples;
     - YCbCr to RGB by jdcolor.c's 16-bit fixed-point tables; RGB to gray
       by jccolor.c's weights; YCbCr to gray is Y.
   What it refuses, with a message: progressive, lossless, hierarchical
   and arithmetic-coded files, 12-bit samples, four components (CMYK,
   YCCK), and an EXIF orientation other than 1 (libjpeg's readers rotate
   such a file; this decoder does not).

   jpeg_info(data, n, info, err, errlen) parses the headers up to the first
   scan: info = {height, width, components}. jpeg_decode(data, n, gray,
   out, err, errlen) decodes into out: height * width * 3 bytes of RGB, or
   height * width bytes of gray when gray is set. Both return 0, or -1
   with a message in err. data/image_io.py calls them through ctypes;
   kernels/build.py::load_host builds this file with the host C compiler. */

#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

static const uint8_t NATURAL[64] = {
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

#define LOOK 9

typedef struct {
    int defined;
    uint8_t look_len[1 << LOOK];     /* 0: the code is longer than LOOK */
    uint8_t look_sym[1 << LOOK];
    int32_t maxcode[18];             /* -1: no code of that length */
    int32_t valoff[17];              /* huffval index minus the first code */
    uint8_t huffval[256];
} Huff;

typedef struct {
    int id, h, v, tq;
    int dc, ac;                      /* table slots of the current scan */
    int dw, dh;                      /* the component's own size */
    int pw, ph;                      /* its plane: whole MCUs */
    uint8_t *plane;
    int pred;
} Comp;

typedef struct {
    const uint8_t *p, *end;
    char *err;
    int errlen;
    uint16_t qt[4][64];
    int qt_defined[4];
    Huff dc[4], ac[4];
    int width, height, ncomp, hmax, vmax, mcux, mcuy;
    int frame_seen, restart_interval;
    int jfif, adobe, adobe_transform;
    Comp comp[3];
    /* the entropy decoder's bit buffer */
    uint64_t bits;
    int nbits;
    int marker_hit;
} Dec;

static int fail(Dec *d, const char *fmt, ...) {
    if (d->err && d->errlen > 0) {
        va_list ap;
        va_start(ap, fmt);
        vsnprintf(d->err, (size_t)d->errlen, fmt, ap);
        va_end(ap);
    }
    return -1;
}

/* ---- headers ----------------------------------------------------------- */

static int u16(const uint8_t *p) { return (p[0] << 8) | p[1]; }

static int build_huff(Dec *d, Huff *t, const uint8_t *counts,
                      const uint8_t *vals, int nvals) {
    int code = 0, k = 0, len, i;
    memset(t, 0, sizeof *t);
    memcpy(t->huffval, vals, (size_t)nvals);
    for (len = 1; len <= 16; ++len) {
        int n = counts[len - 1];
        t->valoff[len] = k - code;
        if (n) {
            for (i = 0; i < n; ++i, ++code, ++k) {
                if (len <= LOOK) {
                    int shift = LOOK - len, j;
                    for (j = 0; j < (1 << shift); ++j) {
                        t->look_len[(code << shift) | j] = (uint8_t)len;
                        t->look_sym[(code << shift) | j] = vals[k];
                    }
                }
            }
            t->maxcode[len] = code - 1;
            if (code - 1 >= (1 << len))
                return fail(d, "bad Huffman table");
        } else {
            t->maxcode[len] = -1;
        }
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;
    t->defined = 1;
    return 0;
}

static int parse_dht(Dec *d, const uint8_t *s, int n) {
    while (n > 0) {
        int tc = s[0] >> 4, th = s[0] & 15, total = 0, i;
        if (n < 17 || th > 3 || tc > 1) return fail(d, "bad DHT segment");
        for (i = 0; i < 16; ++i) total += s[1 + i];
        if (total > 256 || n < 17 + total) return fail(d, "bad DHT segment");
        if (build_huff(d, tc ? &d->ac[th] : &d->dc[th], s + 1, s + 17,
                       total))
            return -1;
        s += 17 + total;
        n -= 17 + total;
    }
    return 0;
}

static int parse_dqt(Dec *d, const uint8_t *s, int n) {
    while (n > 0) {
        int pq = s[0] >> 4, tq = s[0] & 15, i;
        int size = 1 + 64 * (pq ? 2 : 1);
        if (tq > 3 || pq > 1 || n < size) return fail(d, "bad DQT segment");
        for (i = 0; i < 64; ++i)
            d->qt[tq][NATURAL[i]] = (uint16_t)(pq ? u16(s + 1 + 2 * i)
                                                  : s[1 + i]);
        d->qt_defined[tq] = 1;
        s += size;
        n -= size;
    }
    return 0;
}

static int parse_sof(Dec *d, const uint8_t *s, int n) {
    int i;
    if (n < 6) return fail(d, "bad SOF segment");
    if (s[0] != 8)
        return fail(d, "%d-bit JPEG samples are not decoded (8-bit are)",
                    s[0]);
    d->height = u16(s + 1);
    d->width = u16(s + 3);
    d->ncomp = s[5];
    if (d->height == 0)
        return fail(d, "JPEG height 0 (a DNL marker) is not decoded");
    if (d->width == 0) return fail(d, "JPEG width 0");
    if (d->ncomp == 4)
        return fail(d, "four-component (CMYK/YCCK) JPEG is not decoded");
    if (d->ncomp != 1 && d->ncomp != 3)
        return fail(d, "%d-component JPEG is not decoded", d->ncomp);
    if (n < 6 + 3 * d->ncomp) return fail(d, "bad SOF segment");
    d->hmax = d->vmax = 1;
    for (i = 0; i < d->ncomp; ++i) {
        Comp *c = &d->comp[i];
        c->id = s[6 + 3 * i];
        c->h = s[7 + 3 * i] >> 4;
        c->v = s[7 + 3 * i] & 15;
        c->tq = s[8 + 3 * i];
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3)
            return fail(d, "bad JPEG component parameters");
        if (c->h > d->hmax) d->hmax = c->h;
        if (c->v > d->vmax) d->vmax = c->v;
    }
    d->mcux = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
    d->mcuy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
    for (i = 0; i < d->ncomp; ++i) {
        Comp *c = &d->comp[i];
        c->dw = (int)(((int64_t)d->width * c->h + d->hmax - 1) / d->hmax);
        c->dh = (int)(((int64_t)d->height * c->v + d->vmax - 1) / d->vmax);
        c->pw = d->mcux * c->h * 8;
        c->ph = d->mcuy * c->v * 8;
    }
    d->frame_seen = 1;
    return 0;
}

/* Orientation (tag 0x0112) of an APP1 Exif segment's IFD0; 1 when absent. */
static int exif_orientation(const uint8_t *s, int n) {
    const uint8_t *t;
    int le, count, i;
    uint32_t off;
    if (n < 14 || memcmp(s, "Exif\0\0", 6) != 0) return 1;
    t = s + 6;
    n -= 6;
    if (t[0] == 'I' && t[1] == 'I') le = 1;
    else if (t[0] == 'M' && t[1] == 'M') le = 0;
    else return 1;
#define RD16(q) (le ? ((q)[0] | ((q)[1] << 8)) : (((q)[0] << 8) | (q)[1]))
#define RD32(q) (le ? ((uint32_t)(q)[0] | ((uint32_t)(q)[1] << 8) | \
                       ((uint32_t)(q)[2] << 16) | ((uint32_t)(q)[3] << 24)) \
                    : (((uint32_t)(q)[0] << 24) | ((uint32_t)(q)[1] << 16) | \
                       ((uint32_t)(q)[2] << 8) | (uint32_t)(q)[3]))
    off = RD32(t + 4);
    if (off + 2 > (uint32_t)n) return 1;
    count = RD16(t + off);
    for (i = 0; i < count; ++i) {
        const uint8_t *e = t + off + 2 + 12 * i;
        if (e + 12 > t + n) break;
        if (RD16(e) == 0x0112) return RD16(e + 8);
    }
#undef RD16
#undef RD32
    return 1;
}

/* Parse markers until SOS (returns 1 with *sos at the scan header) or EOI
   (returns 0). */
static int next_segment(Dec *d, const uint8_t **sos, int *sos_len) {
    for (;;) {
        int m, len;
        while (d->p < d->end && *d->p != 0xFF) ++d->p;   /* skip garbage */
        while (d->p < d->end && *d->p == 0xFF) ++d->p;   /* fill bytes */
        if (d->p >= d->end) return fail(d, "JPEG ends before EOI");
        m = *d->p++;
        if (m == 0xD9) return 0;                          /* EOI */
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
        if (d->end - d->p < 2) return fail(d, "truncated JPEG marker");
        len = u16(d->p);
        if (len < 2 || d->end - d->p < len)
            return fail(d, "truncated JPEG segment");
        {
            const uint8_t *s = d->p + 2;
            int n = len - 2;
            d->p += len;
            if (m == 0xC0 || m == 0xC1) {
                if (d->frame_seen) return fail(d, "two JPEG frames");
                if (parse_sof(d, s, n)) return -1;
            } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
                return fail(d, "progressive JPEG is not decoded "
                               "(baseline only)");
            } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
                return fail(d, "lossless JPEG is not decoded");
            } else if (m == 0xC5) {
                return fail(d, "hierarchical JPEG is not decoded");
            } else if (m == 0xC9 || m == 0xCC || m == 0xCD) {
                return fail(d, "arithmetic-coded JPEG is not decoded");
            } else if (m == 0xC4) {
                if (parse_dht(d, s, n)) return -1;
            } else if (m == 0xDB) {
                if (parse_dqt(d, s, n)) return -1;
            } else if (m == 0xDD) {
                if (n < 2) return fail(d, "bad DRI segment");
                d->restart_interval = u16(s);
            } else if (m == 0xE0) {
                if (n >= 5 && memcmp(s, "JFIF\0", 5) == 0) d->jfif = 1;
            } else if (m == 0xE1) {
                int o = exif_orientation(s, n);
                if (o != 1)
                    return fail(d, "EXIF orientation %d is not applied "
                                   "(only 1 is read)", o);
            } else if (m == 0xEE) {
                if (n >= 12 && memcmp(s, "Adobe", 5) == 0) {
                    d->adobe = 1;
                    d->adobe_transform = s[11];
                }
            } else if (m == 0xDA) {
                *sos = s;
                *sos_len = n;
                return 1;
            }
        }
    }
}

/* ---- entropy decoding -------------------------------------------------- */

static inline void fill(Dec *d) {
    while (d->nbits <= 56) {
        int b = 0;
        if (!d->marker_hit && d->p < d->end) {
            b = *d->p;
            if (b == 0xFF) {
                int nx = d->p + 1 < d->end ? d->p[1] : 0xD9;
                if (nx == 0x00) {
                    d->p += 2;
                } else {
                    d->marker_hit = 1;      /* a marker: feed zeros */
                    b = 0;
                }
            } else {
                d->p++;
            }
        }
        d->bits |= (uint64_t)b << (56 - d->nbits);
        d->nbits += 8;
    }
}

static inline int getbits(Dec *d, int n) {
    int v;
    if (n == 0) return 0;
    if (d->nbits < n) fill(d);
    v = (int)(d->bits >> (64 - n));
    d->bits <<= n;
    d->nbits -= n;
    return v;
}

static inline int extend(int v, int t) {
    return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

static inline int decode_huff(Dec *d, const Huff *t) {
    int peek, len, code;
    if (d->nbits < 16) fill(d);
    peek = (int)(d->bits >> (64 - LOOK));
    len = t->look_len[peek];
    if (len) {
        d->bits <<= len;
        d->nbits -= len;
        return t->look_sym[peek];
    }
    for (len = LOOK + 1; len <= 16; ++len) {
        code = (int)(d->bits >> (64 - len));
        if (code <= t->maxcode[len]) {
            d->bits <<= len;
            d->nbits -= len;
            return t->huffval[(t->valoff[len] + code) & 0xFF];
        }
    }
    /* a corrupt code: libjpeg warns and decodes zero */
    d->bits <<= 16;
    d->nbits -= 16;
    return 0;
}

static inline uint8_t idct_limit(int64_t x) {
    int i = (int)(x & 1023);
    if (i < 128) return (uint8_t)(i + 128);
    if (i < 512) return 255;
    if (i < 896) return 0;
    return (uint8_t)(i - 896);
}

/* jidctint.c's jpeg_idct_islow on one block of coefficients (natural
   order) with its quantisation table, into out (row stride `stride`). */
static void idct_islow(const int16_t *coef, const uint16_t *q, uint8_t *out,
                       int stride) {
    int32_t ws[64];
    int ctr;
    for (ctr = 0; ctr < 8; ++ctr) {
        const int16_t *in = coef + ctr;
        const uint16_t *qq = q + ctr;
        int32_t *w = ws + ctr;
        int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
        int64_t z1, z2, z3, z4, z5;
        if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
            in[40] == 0 && in[48] == 0 && in[56] == 0) {
            int32_t dc = (int32_t)(in[0] * qq[0]) * (1 << PASS1_BITS);
            int k;
            for (k = 0; k < 8; ++k) w[8 * k] = dc;
            continue;
        }
        z2 = in[16] * qq[16];
        z3 = in[48] * qq[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = in[0] * qq[0];
        z3 = in[32] * qq[32];
        tmp0 = (z2 + z3) * (1 << CONST_BITS);
        tmp1 = (z2 - z3) * (1 << CONST_BITS);
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        tmp0 = in[56] * qq[56];
        tmp1 = in[40] * qq[40];
        tmp2 = in[24] * qq[24];
        tmp3 = in[8] * qq[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        z4 = tmp1 + tmp3;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        w[0] = (int32_t)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
        w[56] = (int32_t)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
        w[8] = (int32_t)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
        w[48] = (int32_t)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
        w[16] = (int32_t)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
        w[40] = (int32_t)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
        w[24] = (int32_t)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
        w[32] = (int32_t)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
    }
    for (ctr = 0; ctr < 8; ++ctr) {
        const int32_t *w = ws + 8 * ctr;
        uint8_t *o = out + (size_t)ctr * stride;
        int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
        int64_t z1, z2, z3, z4, z5;
        const int n = CONST_BITS + PASS1_BITS + 3;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
            w[6] == 0 && w[7] == 0) {
            uint8_t dc = idct_limit(DESCALE((int64_t)w[0], PASS1_BITS + 3));
            memset(o, dc, 8);
            continue;
        }
        z2 = w[2];
        z3 = w[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
        tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        z4 = tmp1 + tmp3;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        o[0] = idct_limit(DESCALE(tmp10 + tmp3, n));
        o[7] = idct_limit(DESCALE(tmp10 - tmp3, n));
        o[1] = idct_limit(DESCALE(tmp11 + tmp2, n));
        o[6] = idct_limit(DESCALE(tmp11 - tmp2, n));
        o[2] = idct_limit(DESCALE(tmp12 + tmp1, n));
        o[5] = idct_limit(DESCALE(tmp12 - tmp1, n));
        o[3] = idct_limit(DESCALE(tmp13 + tmp0, n));
        o[4] = idct_limit(DESCALE(tmp13 - tmp0, n));
    }
}

static int decode_block(Dec *d, Comp *c, int bx, int by) {
    int16_t coef[64];
    const Huff *dc = &d->dc[c->dc], *ac = &d->ac[c->ac];
    int t, k;
    memset(coef, 0, sizeof coef);
    t = decode_huff(d, dc);
    if (t > 11) return fail(d, "bad JPEG DC code");
    if (t) c->pred += extend(getbits(d, t), t);
    coef[0] = (int16_t)c->pred;
    for (k = 1; k < 64;) {
        int rs = decode_huff(d, ac), r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            if (k > 63) break;
            coef[NATURAL[k]] = (int16_t)extend(getbits(d, s), s);
            ++k;
        } else if (r == 15) {
            k += 16;
        } else {
            break;
        }
    }
    idct_islow(coef, d->qt[c->tq],
               c->plane + (size_t)by * 8 * c->pw + (size_t)bx * 8, c->pw);
    return 0;
}

/* Skip the bit buffer's rest and the RSTn marker; reset the predictions. */
static void restart(Dec *d, int ns, Comp **sc) {
    int i;
    d->bits = 0;
    d->nbits = 0;
    d->marker_hit = 0;
    while (d->p + 1 < d->end) {
        if (d->p[0] == 0xFF && d->p[1] >= 0xD0 && d->p[1] <= 0xD7) {
            d->p += 2;
            break;
        }
        if (d->p[0] == 0xFF && d->p[1] != 0x00 && d->p[1] != 0xFF) break;
        ++d->p;
    }
    for (i = 0; i < ns; ++i) sc[i]->pred = 0;
}

static int decode_scan(Dec *d, const uint8_t *s, int n) {
    Comp *sc[3];
    int ns, i, j, units_x, units_y, ux, uy, left;
    if (!d->frame_seen) return fail(d, "JPEG scan before its frame");
    ns = s[0];
    if (ns < 1 || ns > d->ncomp || n < 1 + 2 * ns + 3)
        return fail(d, "bad SOS segment");
    for (i = 0; i < ns; ++i) {
        int id = s[1 + 2 * i], tables = s[2 + 2 * i];
        sc[i] = NULL;
        for (j = 0; j < d->ncomp; ++j)
            if (d->comp[j].id == id) sc[i] = &d->comp[j];
        if (!sc[i]) return fail(d, "JPEG scan names an unknown component");
        sc[i]->dc = tables >> 4;
        sc[i]->ac = tables & 15;
        if (sc[i]->dc > 3 || sc[i]->ac > 3 || !d->dc[sc[i]->dc].defined ||
            !d->ac[sc[i]->ac].defined)
            return fail(d, "JPEG scan uses an undefined Huffman table");
        if (!d->qt_defined[sc[i]->tq])
            return fail(d, "JPEG component uses an undefined "
                           "quantisation table");
        sc[i]->pred = 0;
    }
    d->bits = 0;
    d->nbits = 0;
    d->marker_hit = 0;
    if (ns == 1) {                          /* one block per MCU */
        units_x = (sc[0]->dw + 7) / 8;
        units_y = (sc[0]->dh + 7) / 8;
    } else {
        units_x = d->mcux;
        units_y = d->mcuy;
    }
    left = d->restart_interval;
    for (uy = 0; uy < units_y; ++uy) {
        for (ux = 0; ux < units_x; ++ux) {
            if (d->restart_interval) {
                if (left == 0) {
                    restart(d, ns, sc);
                    left = d->restart_interval;
                }
                --left;
            }
            if (ns == 1) {
                if (decode_block(d, sc[0], ux, uy)) return -1;
                continue;
            }
            for (i = 0; i < ns; ++i) {
                Comp *c = sc[i];
                int bx, by;
                for (by = 0; by < c->v; ++by)
                    for (bx = 0; bx < c->h; ++bx)
                        if (decode_block(d, c, ux * c->h + bx,
                                         uy * c->v + by))
                            return -1;
            }
        }
    }
    /* on to the next marker */
    while (d->p + 1 < d->end &&
           !(d->p[0] == 0xFF && d->p[1] != 0x00 && d->p[1] != 0xFF &&
             !(d->p[1] >= 0xD0 && d->p[1] <= 0xD7)))
        ++d->p;
    return 0;
}

/* ---- upsampling and colour ---------------------------------------------- */

/* The component c upsampled to a full-size plane out (width w, rows up to
   height h), as jdsample.c's method for its factors. */
static void upsample(const Dec *d, const Comp *c, uint8_t *out, int w,
                     int h) {
    int fx = d->hmax / c->h, fy = d->vmax / c->v, x, y;
    int exact = d->hmax % c->h == 0 && d->vmax % c->v == 0;
    const uint8_t *pl = c->plane;
    int pw = c->pw, cw = c->dw, ch = c->dh;
    if (fx == 1 && fy == 1 && exact) {
        for (y = 0; y < h; ++y) memcpy(out + (size_t)y * w,
                                       pl + (size_t)y * pw, (size_t)w);
        return;
    }
    if (fx == 2 && fy == 1 && exact && cw > 2) {          /* h2v1 fancy */
        uint8_t *row = malloc((size_t)cw * 2);
        for (y = 0; y < h; ++y) {
            const uint8_t *in = pl + (size_t)y * pw;
            row[0] = in[0];
            row[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
            for (x = 1; x < cw - 1; ++x) {
                int v3 = in[x] * 3;
                row[2 * x] = (uint8_t)((v3 + in[x - 1] + 1) >> 2);
                row[2 * x + 1] = (uint8_t)((v3 + in[x + 1] + 2) >> 2);
            }
            row[2 * cw - 2] = (uint8_t)((in[cw - 1] * 3 + in[cw - 2] + 1) >> 2);
            row[2 * cw - 1] = in[cw - 1];
            memcpy(out + (size_t)y * w, row, (size_t)w);
        }
        free(row);
        return;
    }
    if (fx == 1 && fy == 2 && exact) {                    /* h1v2 fancy */
        for (y = 0; y < h; ++y) {
            int iy = y >> 1, v = y & 1, bias = v ? 2 : 1;
            int ny = v ? (iy + 1 < ch ? iy + 1 : ch - 1)
                       : (iy > 0 ? iy - 1 : 0);
            const uint8_t *in0 = pl + (size_t)iy * pw;
            const uint8_t *in1 = pl + (size_t)ny * pw;
            uint8_t *o = out + (size_t)y * w;
            for (x = 0; x < w; ++x)
                o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
        }
        return;
    }
    if (fx == 2 && fy == 2 && exact && cw > 2) {          /* h2v2 fancy */
        uint8_t *row = malloc((size_t)cw * 2);
        for (y = 0; y < h; ++y) {
            int iy = y >> 1, v = y & 1;
            int ny = v ? (iy + 1 < ch ? iy + 1 : ch - 1)
                       : (iy > 0 ? iy - 1 : 0);
            const uint8_t *in0 = pl + (size_t)iy * pw;
            const uint8_t *in1 = pl + (size_t)ny * pw;
            int this_sum = in0[0] * 3 + in1[0];
            int next_sum = in0[1] * 3 + in1[1];
            int last_sum;
            row[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
            row[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
            last_sum = this_sum;
            this_sum = next_sum;
            for (x = 1; x < cw - 1; ++x) {
                next_sum = in0[x + 1] * 3 + in1[x + 1];
                row[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
                row[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
                last_sum = this_sum;
                this_sum = next_sum;
            }
            row[2 * cw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
            row[2 * cw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
            memcpy(out + (size_t)y * w, row, (size_t)w);
        }
        free(row);
        return;
    }
    /* integral box replication (jdsample.c int_upsample, h2v1_upsample,
       h2v2_upsample) */
    for (y = 0; y < h; ++y) {
        const uint8_t *in = pl + (size_t)(y / fy) * pw;
        uint8_t *o = out + (size_t)y * w;
        for (x = 0; x < w; ++x) o[x] = in[x / fx];
    }
}

static inline uint8_t clamp255(int v) {
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

#define SCALEBITS 16
#define ONE_HALF ((int32_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int32_t)((x) * (1L << SCALEBITS) + 0.5))

static int convert(Dec *d, int gray, uint8_t *out) {
    int w = d->width, h = d->height, ci, i;
    size_t npx = (size_t)w * h;
    int rgb = 0;
    uint8_t *full[3] = {NULL, NULL, NULL};
    int needed = (d->ncomp == 1) ? 1 : 3;
    if (d->ncomp == 3) {
        if (d->jfif) rgb = 0;
        else if (d->adobe) rgb = d->adobe_transform == 0;
        else if (d->comp[0].id == 'R' && d->comp[1].id == 'G' &&
                 d->comp[2].id == 'B') rgb = 1;
        if (gray && !rgb) needed = 1;             /* Y is the gray image */
    }
    for (ci = 0; ci < needed; ++ci) {
        full[ci] = malloc(npx);
        if (!full[ci]) {
            for (i = 0; i < ci; ++i) free(full[i]);
            return fail(d, "out of memory");
        }
        upsample(d, &d->comp[ci], full[ci], w, h);
    }
    if (needed == 1) {
        if (gray) memcpy(out, full[0], npx);
        else for (i = 0; i < (int64_t)npx; ++i)
            out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
    } else if (rgb) {
        if (gray) {                               /* jccolor.c rgb_gray */
            for (i = 0; i < (int64_t)npx; ++i)
                out[i] = (uint8_t)((FIX(0.29900) * full[0][i] +
                                    FIX(0.58700) * full[1][i] +
                                    FIX(0.11400) * full[2][i] + ONE_HALF)
                                   >> SCALEBITS);
        } else {
            for (i = 0; i < (int64_t)npx; ++i) {
                out[3 * i] = full[0][i];
                out[3 * i + 1] = full[1][i];
                out[3 * i + 2] = full[2][i];
            }
        }
    } else {                                      /* jdcolor.c ycc_rgb */
        static int cr_r[256], cb_b[256];
        static int32_t cr_g[256], cb_g[256];
        static int tables = 0;
        if (!tables) {
            int x;
            for (i = 0, x = -128; i < 256; ++i, ++x) {
                cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
                cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
                cr_g[i] = -FIX(0.71414) * x;
                cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
            }
            tables = 1;
        }
        for (i = 0; i < (int64_t)npx; ++i) {
            int y = full[0][i], cb = full[1][i], cr = full[2][i];
            out[3 * i] = clamp255(y + cr_r[cr]);
            out[3 * i + 1] = clamp255(y + (int)((cb_g[cb] + cr_g[cr])
                                                >> SCALEBITS));
            out[3 * i + 2] = clamp255(y + cb_b[cb]);
        }
    }
    for (ci = 0; ci < needed; ++ci) free(full[ci]);
    return 0;
}

/* ---- entry points ------------------------------------------------------- */

static int start(Dec *d, const uint8_t *data, int64_t n, char *err,
                 int errlen) {
    memset(d, 0, sizeof *d);
    d->p = data;
    d->end = data + n;
    d->err = err;
    d->errlen = errlen;
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
        return fail(d, "not a JPEG file (no SOI marker)");
    d->p += 2;
    return 0;
}

int jpeg_info(const uint8_t *data, int64_t n, int32_t *info, char *err,
              int errlen) {
    Dec d;
    const uint8_t *sos;
    int sos_len, r;
    if (start(&d, data, n, err, errlen)) return -1;
    r = next_segment(&d, &sos, &sos_len);
    if (r < 0) return -1;
    if (!d.frame_seen) return fail(&d, "JPEG without a baseline frame");
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    return 0;
}

int jpeg_decode(const uint8_t *data, int64_t n, int gray, uint8_t *out,
                char *err, int errlen) {
    Dec d;
    const uint8_t *sos;
    int sos_len, r, i, scans = 0, rc = -1;
    if (start(&d, data, n, err, errlen)) return -1;
    for (;;) {
        r = next_segment(&d, &sos, &sos_len);
        if (r < 0) goto done;
        if (r == 0) break;
        if (!scans) {
            for (i = 0; i < d.ncomp; ++i) {
                Comp *c = &d.comp[i];
                c->plane = calloc((size_t)c->pw * c->ph, 1);
                if (!c->plane) {
                    fail(&d, "out of memory");
                    goto done;
                }
            }
        }
        if (decode_scan(&d, sos, sos_len)) goto done;
        ++scans;
    }
    if (!scans) {
        fail(&d, "JPEG without a scan");
        goto done;
    }
    rc = convert(&d, gray, out);
done:
    for (i = 0; i < 3; ++i) free(d.comp[i].plane);
    return rc;
}
