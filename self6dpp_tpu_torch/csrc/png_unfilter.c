/* Undo the five PNG scanline filters (PNG spec, section 9) on the host.

   The filters of a row are sequential along it (Sub, Average and Paeth
   each read the byte bpp to the left after it was undone) and Up, Average
   and Paeth read the row above after it was undone, so the decode is one
   pass in row order. data/image_io.py calls it through ctypes; it is built
   with the host C compiler by kernels/build.py::load_host.

   png_unfilter(raw, out, height, stride, bpp):
     raw    height * (1 + stride) bytes: each row's filter type, then its
            stride filtered bytes;
     out    height * stride bytes, the unfiltered rows;
     bpp    bytes per pixel (at least 1), the left neighbour's distance.
   Returns 0; -1 if it cannot allocate its zero row; or 1 + the index of
   the first row whose filter type is not 0-4 (the rows before it are
   written). */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* a if pa <= pb and pa <= pc, else b if pb <= pc, else c; as two selects
   by masks, without branches (camera noise makes them unpredictable). */
static inline int paeth(int a, int b, int c) {
    int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
    int m = -(pb < pa);
    int pred = (a & ~m) | (b & m), best = (pa & ~m) | (pb & m);
    m = -(pc < best);
    return (pred & ~m) | (c & m);
}

int png_unfilter(const uint8_t *raw, uint8_t *out, int64_t height,
                 int64_t stride, int64_t bpp) {
    uint8_t *zeros = calloc((size_t)(stride > 0 ? stride : 1), 1);
    if (!zeros) return -1;
    const uint8_t *up = zeros;
    int64_t y, i;
    for (y = 0; y < height; ++y) {
        const uint8_t *line = raw + y * (stride + 1) + 1;
        uint8_t *cur = out + y * stride;
        int64_t lead = bpp < stride ? bpp : stride;
        switch (raw[y * (stride + 1)]) {
        case 0:                                             /* None */
            memcpy(cur, line, (size_t)stride);
            break;
        case 1:                                             /* Sub */
            memcpy(cur, line, (size_t)lead);
            for (i = bpp; i < stride; ++i)
                cur[i] = (uint8_t)(line[i] + cur[i - bpp]);
            break;
        case 2:                                             /* Up */
            for (i = 0; i < stride; ++i)
                cur[i] = (uint8_t)(line[i] + up[i]);
            break;
        case 3:                                             /* Average */
            for (i = 0; i < lead; ++i)
                cur[i] = (uint8_t)(line[i] + (up[i] >> 1));
            for (i = bpp; i < stride; ++i)
                cur[i] = (uint8_t)(line[i] + ((cur[i - bpp] + up[i]) >> 1));
            break;
        case 4:                                             /* Paeth */
            for (i = 0; i < lead; ++i)
                cur[i] = (uint8_t)(line[i] + up[i]);
            for (i = bpp; i < stride; ++i)
                cur[i] = (uint8_t)(line[i] + paeth(cur[i - bpp], up[i],
                                                   up[i - bpp]));
            break;
        default:
            free(zeros);
            return (int)(y + 1);
        }
        up = cur;
    }
    free(zeros);
    return 0;
}
