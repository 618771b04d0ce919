/* Farthest-point sampling over mesh vertices on the host: the counterpart
   of the JAX package's native FPS (the same greedy O(k n) algorithm with an
   incremental min-distance table), made deterministic and equal to
   ops/fps.py::fps_numpy bit for bit:

     - the centroid is summed in float32 row after row and divided once
       (numpy's mean(axis=0) of a C-contiguous (n, 3) float32 array: the
       sum in float32, the quotient rounded once from double);
     - every squared distance is numpy's ((p - q)**2).sum(axis=1): three
       float32 squares summed left to right (built without FMA
       contraction, kernels/build.py);
     - the min-distance table starts at +inf;
     - ties go to the lowest index, for the starting arg-min and for each
       step's arg-max: the scan runs in increasing index and keeps the
       first largest (smallest) value.

   It runs on one thread: the loader calls it twice per class, once, on
   meshes of a few thousand vertices.

   ops/fps.py calls it through ctypes; kernels/build.py::load_host builds
   it with the host C compiler.

   farthest_point_sampling(points, n, k, out_idx, init_center):
     points       n x 3 float32, C-contiguous;
     out_idx      k int32, the chosen indices in order;
     init_center  nonzero: start from the point nearest the centroid,
                  else from point 0.
   Returns 0, or -1 if it cannot allocate its table. */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>

static inline float sqdist(const float *p, float qx, float qy, float qz) {
    float dx = p[0] - qx, dy = p[1] - qy, dz = p[2] - qz;
    float s = dx * dx;
    s = s + dy * dy;
    return s + dz * dz;
}

static int64_t nearest_centroid(const float *points, int64_t n) {
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    for (int64_t i = 0; i < n; ++i) {
        sx += points[3 * i];
        sy += points[3 * i + 1];
        sz += points[3 * i + 2];
    }
    float cx = (float)((double)sx / (double)n);
    float cy = (float)((double)sy / (double)n);
    float cz = (float)((double)sz / (double)n);
    int64_t first = 0;
    float best = INFINITY;
    for (int64_t i = 0; i < n; ++i) {
        float d = sqdist(points + 3 * i, cx, cy, cz);
        if (d < best) { best = d; first = i; }
    }
    return first;
}

int farthest_point_sampling(const float *points, int64_t n, int64_t k,
                            int32_t *out_idx, int32_t init_center) {
    if (n <= 0 || k <= 0) return 0;
    float *mind = (float *)malloc((size_t)n * sizeof(float));
    if (!mind) return -1;
    for (int64_t i = 0; i < n; ++i) mind[i] = INFINITY;
    int64_t cur = init_center ? nearest_centroid(points, n) : 0;
    for (int64_t j = 0; j < k; ++j) {
        out_idx[j] = (int32_t)cur;
        const float px = points[3 * cur], py = points[3 * cur + 1],
                    pz = points[3 * cur + 2];
        float best = -INFINITY;
        int64_t besti = 0;
        for (int64_t i = 0; i < n; ++i) {
            float d = sqdist(points + 3 * i, px, py, pz);
            if (d < mind[i]) mind[i] = d;
            if (mind[i] > best || i == 0) {
                best = mind[i];
                besti = i;
            }
        }
        cur = besti;
    }
    free(mind);
    return 0;
}
