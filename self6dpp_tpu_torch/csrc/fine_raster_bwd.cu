// Fine stage of the tile-binned rasterizer, backward.
//
// Replaces the TPU kernel self6dpp_tpu/ops/raster_pallas.py::_fine_bwd_kernel
// (reached through fine_raster's custom_vjp -> _fine_bwd_rule, pallas_call in
// _fine_bwd_rule). The plain PyTorch version of the same function is
// self6dpp_tpu_torch/ops/raster_cuda.py::fine_raster_bwd_partials_plain.
//
// Input: the face table and per-tile candidates of the forward (see
// fine_raster_fwd.cu) and the cotangents of prob, depth (B, H, W) and attr
// (B, H, W, D). Output: per-(tile, candidate) gradients of the face-table
// row, partials (T, K, C) with C = 11 + 3D; the sum over tiles into d ftab
// (an index_add_, the backward of the candidate gather) happens outside.
//
// One block per (image, tile), one thread per pixel. The block gathers its
// candidates into shared memory as the forward does, and every thread
// recomputes its pixel's forward (winner, its edge functions, the
// silhouette product). Then:
//   * the winner's row gets the gradients through the perspective-correct
//     (or affine) barycentrics, the clip-and-renormalise chain with its
//     strict 0 < b < 1 masks and the edge functions and signed area, added
//     into a shared [K][C] array with shared-memory atomics;
//   * with the silhouette, a pixel outside every face gives every valid
//     candidate k the gradient of 1 - prod(1 - p) through the leave-one-out
//     product prod / (1 - p_k) (0 where 1 - p_k <= 1e-6) and p_k =
//     exp(-d^2 / sigma^2), d^2 the squared distance to the nearest edge
//     (ties to edge 01, then 12, then 20), with the foot parameter held
//     fixed (envelope theorem). The warp sums these over its 32 pixels with
//     shuffles and one lane adds them to shared memory. A pixel inside a
//     face has a product of exactly 0, so its silhouette terms are 0: the
//     block needs no separate boundary-tile flag.
// The z-test is piecewise constant and the `valid` column gets nothing.
// A tile with no valid candidate writes zeros.
//
// What bounds it: per pixel and valid candidate ~22 f32 operations for the
// forward recompute and, at a silhouette pixel, ~60 more for the distance
// and its gradient; against 20 bytes of cotangent per pixel (D = 3) and
// K * C * 4 bytes of partials per tile. The design reads each cotangent
// once, keeps the candidates and the accumulators in shared memory and
// writes each partial once; shared-memory atomics make the last bits of a
// sum vary from run to run, so it is held against the plain version at a
// tolerance.
//
// Built with --fmad=false, like the forward, so the recomputed edge tests
// (and so the winner) agree bitwise with the forward and the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGeo = 11;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float seg_d2(float pu, float pv, float ax, float ay,
                                        float bx, float by) {
  const float abx = bx - ax, aby = by - ay;
  const float apx = pu - ax, apy = pv - ay;
  float tt = (apx * abx + apy * aby) / fmaxf(abx * abx + aby * aby, 1e-12f);
  tt = fminf(fmaxf(tt, 0.f), 1.f);
  const float dx = apx - tt * abx;
  const float dy = apy - tt * aby;
  return dx * dx + dy * dy;
}

// d(d2 to segment ab) * dd with respect to (ax, ay, bx, by), added to g.
__device__ __forceinline__ void seg_bwd(float pu, float pv, float ax, float ay,
                                        float bx, float by, float dd,
                                        float* gax, float* gay, float* gbx,
                                        float* gby) {
  const float abx = bx - ax, aby = by - ay;
  const float apx = pu - ax, apy = pv - ay;
  float tt = (apx * abx + apy * aby) / fmaxf(abx * abx + aby * aby, 1e-12f);
  tt = fminf(fmaxf(tt, 0.f), 1.f);
  const float rx = apx - tt * abx;
  const float ry = apy - tt * aby;
  *gax += -2.f * rx * (1.f - tt) * dd;
  *gay += -2.f * ry * (1.f - tt) * dd;
  *gbx += -2.f * rx * tt * dd;
  *gby += -2.f * ry * tt * dd;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

__global__ void fine_raster_bwd_kernel(
    const float* __restrict__ ftab, const int32_t* __restrict__ cand,
    const float* __restrict__ dprob, const float* __restrict__ ddepth,
    const float* __restrict__ dattr, float* __restrict__ partials, int F,
    int H, int W, int tp, int tw, int Tt, int K, int D, float sigma2,
    int with_prob, int persp) {
  extern __shared__ float smem[];
  const int C = kGeo + 3 * D;
  float* s_row = smem;                                  // K * C candidates
  float* s_grad = s_row + K * C;                        // K * C gradients
  float* s_inv = s_grad + K * C;                        // K: 1 / signed area
  int* s_cand = reinterpret_cast<int*>(s_inv + K);      // K

  const int t = blockIdx.x;
  const int b = t / Tt;
  const int ti = t - b * Tt;
  const int nthr = blockDim.x;
  const int32_t* cand_t = cand + static_cast<size_t>(t) * K;
  const float* ftab_b = ftab + static_cast<size_t>(b) * F * C;
  float* part_t = partials + static_cast<size_t>(t) * K * C;

  for (int k = threadIdx.x; k < K; k += nthr) s_cand[k] = cand_t[k];
  __syncthreads();
  for (int i = threadIdx.x; i < K * C; i += nthr) {
    const int k = i / C;
    const int f = s_cand[k];
    s_row[i] = f >= 0 ? ftab_b[static_cast<size_t>(f) * C + (i - k * C)] : 0.f;
    s_grad[i] = 0.f;
  }
  __syncthreads();
  int any_valid = 0;
  for (int k = threadIdx.x; k < K; k += nthr) {
    const float* r = s_row + k * C;
    const float area = (r[2] - r[0]) * (r[5] - r[1]) - (r[4] - r[0]) * (r[3] - r[1]);
    s_inv[k] = fabsf(area) > 1e-12f ? 1.f / area : 0.f;
    any_valid |= r[7] > 0.5f;
  }
  any_valid = __syncthreads_or(any_valid);
  if (!any_valid) {                        // uniform across the block
    for (int i = threadIdx.x; i < K * C; i += nthr) part_t[i] = 0.f;
    return;
  }

  // pixels past the ragged image edge take part (warp shuffles need every
  // lane) with zero cotangents
  const int ly = threadIdx.x / tp;
  const int lx = threadIdx.x - ly * tp;
  const int py = (ti / tw) * tp + ly;
  const int px = (ti % tw) * tp + lx;
  const bool in_img = py < H && px < W;
  const size_t pix = in_img ? (static_cast<size_t>(b) * H + py) * W + px : 0;
  const float dP = in_img ? dprob[pix] : 0.f;
  const float dd = in_img ? ddepth[pix] : 0.f;
  const float pu = static_cast<float>(px);
  const float pv = static_cast<float>(py);

  // forward recompute: winner, its raw barycentrics and edge functions,
  // and the silhouette product
  int best = -1;
  float bz = 0.f, bw0 = 0.f, bw1 = 0.f, bw2 = 0.f, be0 = 0.f, be1 = 0.f;
  float keep = 1.f;
  for (int k = 0; k < K; ++k) {
    const float* r = s_row + k * C;
    if (!(r[7] > 0.5f)) continue;            // uniform across the block
    const float x0 = r[0], y0 = r[1], x1 = r[2], y1 = r[3], x2 = r[4], y2 = r[5];
    const float inv = s_inv[k];
    const float e0 = (x1 - pu) * (y2 - pv) - (x2 - pu) * (y1 - pv);
    const float e1 = (x2 - pu) * (y0 - pv) - (x0 - pu) * (y2 - pv);
    const float w0 = e0 * inv;
    const float w1 = e1 * inv;
    const float w2 = 1.f - w0 - w1;
    const bool inside = w0 >= 0.f && w1 >= 0.f && w2 >= 0.f;
    if (inside && (best < 0 || r[6] < bz)) {
      best = k;
      bz = r[6];
      bw0 = w0;
      bw1 = w1;
      bw2 = w2;
      be0 = e0;
      be1 = e1;
    }
    if (with_prob) {
      float p = 1.f;
      if (!inside) {
        const float d2 = fminf(fminf(seg_d2(pu, pv, x0, y0, x1, y1),
                                     seg_d2(pu, pv, x1, y1, x2, y2)),
                               seg_d2(pu, pv, x2, y2, x0, y0));
        p = expf(-d2 / sigma2);
      }
      keep *= 1.f - p;
    }
  }

  // the winner's row: attributes, depth and the barycentric chain
  if (best >= 0 && in_img) {
    const float* r = s_row + best * C;
    const float* a = r + kGeo;
    float* g = s_grad + best * C;
    const float c0 = fminf(fmaxf(bw0, 0.f), 1.f);
    const float c1 = fminf(fmaxf(bw1, 0.f), 1.f);
    const float c2 = fminf(fmaxf(bw2, 0.f), 1.f);
    const float bs = fmaxf(c0 + c1 + c2, 1e-8f);
    const float b0 = c0 / bs, b1 = c1 / bs, b2 = c2 / bs;
    const float* da = dattr + pix * D;
    float db0, db1, db2;
    if (persp) {
      const float z0 = r[8], z1 = r[9], z2 = r[10];
      const float p0 = b0 * z0, p1 = b1 * z1, p2 = b2 * z2;
      const float s = fmaxf(p0 + p1 + p2, 1e-12f);
      const float q0 = p0 / s, q1 = p1 / s, q2 = p2 / s;
      float dq0 = 0.f, dq1 = 0.f, dq2 = 0.f;
      for (int d = 0; d < D; ++d) {
        const float gd = da[d];
        dq0 += a[d] * gd;
        dq1 += a[D + d] * gd;
        dq2 += a[2 * D + d] * gd;
        atomicAdd(g + kGeo + d, q0 * gd);
        atomicAdd(g + kGeo + D + d, q1 * gd);
        atomicAdd(g + kGeo + 2 * D + d, q2 * gd);
      }
      const float mixq = q0 * dq0 + q1 * dq1 + q2 * dq2;
      const float ds_extra = -dd / (s * s);
      const float dp0 = (dq0 - mixq) / s + ds_extra;
      const float dp1 = (dq1 - mixq) / s + ds_extra;
      const float dp2 = (dq2 - mixq) / s + ds_extra;
      db0 = dp0 * z0;
      db1 = dp1 * z1;
      db2 = dp2 * z2;
      atomicAdd(g + 8, dp0 * b0);
      atomicAdd(g + 9, dp1 * b1);
      atomicAdd(g + 10, dp2 * b2);
    } else {
      db0 = db1 = db2 = 0.f;
      for (int d = 0; d < D; ++d) {
        const float gd = da[d];
        db0 += a[d] * gd;
        db1 += a[D + d] * gd;
        db2 += a[2 * D + d] * gd;
        atomicAdd(g + kGeo + d, b0 * gd);
        atomicAdd(g + kGeo + D + d, b1 * gd);
        atomicAdd(g + kGeo + 2 * D + d, b2 * gd);
      }
      atomicAdd(g + 6, dd);
    }
    const float mix = b0 * db0 + b1 * db1 + b2 * db2;
    const float dc0 = (bw0 > 0.f && bw0 < 1.f) ? (db0 - mix) / bs : 0.f;
    const float dc1 = (bw1 > 0.f && bw1 < 1.f) ? (db1 - mix) / bs : 0.f;
    const float dc2 = (bw2 > 0.f && bw2 < 1.f) ? (db2 - mix) / bs : 0.f;
    const float dw0 = dc0 - dc2;             // w2 = 1 - w0 - w1
    const float dw1 = dc1 - dc2;
    const float inv = s_inv[best];
    const float de0 = dw0 * inv;
    const float de1 = dw1 * inv;
    const float darea = -(dw0 * be0 + dw1 * be1) * inv * inv;
    const float x0 = r[0], y0 = r[1], x1 = r[2], y1 = r[3], x2 = r[4], y2 = r[5];
    atomicAdd(g + 0, -de1 * (y2 - pv) + darea * (y1 - y2));
    atomicAdd(g + 1, de1 * (x2 - pu) + darea * (x2 - x1));
    atomicAdd(g + 2, de0 * (y2 - pv) + darea * (y2 - y0));
    atomicAdd(g + 3, -de0 * (x2 - pu) - darea * (x2 - x0));
    atomicAdd(g + 4, -de0 * (y1 - pv) + de1 * (y0 - pv) - darea * (y1 - y0));
    atomicAdd(g + 5, de0 * (x1 - pu) - de1 * (x0 - pu) + darea * (x1 - x0));
  }

  // the silhouette: pixels outside every face
  if (with_prob) {
    const bool sil = best < 0 && in_img && dP != 0.f;
    const int lane = threadIdx.x & 31;
    for (int k = 0; k < K; ++k) {
      const float* r = s_row + k * C;
      if (!(r[7] > 0.5f)) continue;          // uniform across the block
      float g[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      bool nz = false;
      if (sil) {
        const float x0 = r[0], y0 = r[1], x1 = r[2], y1 = r[3], x2 = r[4], y2 = r[5];
        const float d01 = seg_d2(pu, pv, x0, y0, x1, y1);
        const float d12 = seg_d2(pu, pv, x1, y1, x2, y2);
        const float d20 = seg_d2(pu, pv, x2, y2, x0, y0);
        const float d2 = fminf(fminf(d01, d12), d20);
        const float p = expf(-d2 / sigma2);
        const float one_m = 1.f - p;
        const float loo = one_m > 1e-6f ? keep / fmaxf(one_m, 1e-6f) : 0.f;
        const float dd2 = -p / sigma2 * (dP * loo);
        nz = dd2 != 0.f;
        if (d01 <= d12 && d01 <= d20)
          seg_bwd(pu, pv, x0, y0, x1, y1, dd2, g + 0, g + 1, g + 2, g + 3);
        else if (d12 < d01 && d12 <= d20)
          seg_bwd(pu, pv, x1, y1, x2, y2, dd2, g + 2, g + 3, g + 4, g + 5);
        else
          seg_bwd(pu, pv, x2, y2, x0, y0, dd2, g + 4, g + 5, g + 0, g + 1);
      }
      if (__any_sync(kFull, nz)) {           // uniform across the warp
        for (int j = 0; j < 6; ++j) {
          const float v = warp_sum(g[j]);
          if (lane == 0) atomicAdd(s_grad + k * C + j, v);
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * C; i += nthr) part_t[i] = s_grad[i];
}

}  // namespace

// Launches one block of tp*tp threads (a multiple of 32) per tile (T = B * Tt
// tiles) on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int fine_raster_bwd(const float* ftab, const int32_t* cand,
                               const float* dprob, const float* ddepth,
                               const float* dattr, float* partials, int T,
                               int F, int H, int W, int tp, int tw, int Tt,
                               int K, int D, float sigma2, int with_prob,
                               int persp, void* stream) {
  const int C = kGeo + 3 * D;
  const size_t smem = static_cast<size_t>(K) * (2 * C + 1) * sizeof(float) +
                      static_cast<size_t>(K) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fine_raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fine_raster_bwd_kernel<<<T, tp * tp, smem, static_cast<cudaStream_t>(stream)>>>(
      ftab, cand, dprob, ddepth, dattr, partials, F, H, W, tp, tw, Tt, K, D,
      sigma2, with_prob, persp);
  return static_cast<int>(cudaGetLastError());
}
