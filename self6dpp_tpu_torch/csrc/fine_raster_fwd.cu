// Fine stage of the tile-binned rasterizer, forward.
//
// Replaces the TPU kernel self6dpp_tpu/ops/raster_pallas.py::_fine_fwd_kernel
// (reached through fine_raster -> _fine_fwd, pallas_call in _fine_fwd). The
// plain PyTorch version of the same function is
// self6dpp_tpu_torch/ops/raster_cuda.py::fine_raster_plain.
//
// Per pixel it finds
//   * the inside face of least face-mean depth, ties to the lowest slot k
//     (the first minimum, as jnp.argmin / torch.argmin pick it);
//   * keep = prod_k (1 - p_k) of the DIB-R soft silhouette, p = 1 inside a
//     face and exp(-d^2 / sigma^2) outside, d the distance to the face's
//     nearest edge segment (only when with_prob); prob = 1 - keep;
// then clips and renormalises the winner's barycentrics and interpolates
// the perspective-correct (persp) or affine attributes and depth. Outputs
// go straight to the (B, H, W[, D]) image layout; pixels past the ragged
// image edge are not written. With a `keep` buffer (the autograd forward)
// keep itself is written too: the backward reads it instead of recomputing
// the forward, and 1 - prob would lose its low bits.
//
// Precondition: the candidates of a tile come as rasterizer.py::_bin_faces
// packs them, valid faces first (empty slots, -1, after them) by ascending
// face-mean depth with stable ties. The first slot then tells an empty
// tile, the count of filled slots ends the loop, and the first face that
// contains a pixel is its z-test winner, after which keep is exactly 0 (0
// times a finite factor): a covered pixel stops there. chip_smoke.py checks
// the order on every input it rasterizes (raster_cuda.py::
// cand_depth_sorted).
//
// Design, one thread per pixel; a warp takes an 8 x 4 block of pixels, a
// block of 256 threads 8 such blocks, so a 32 px tile runs as four blocks
// on up to four SMs (tiles below 16 px: one block of tp^2 threads):
//   * an empty tile (first slot -1) writes its zeros before any barrier
//     and without gathering a face;
//   * otherwise the block counts the filled slots (a prefix) once from
//     cand, gathers only each candidate's geometry into shared memory
//     (vertices, 1 / signed area, bounding box; an invalid face gets an
//     empty box) and lists, in slot order, the candidates within cull_d2
//     of its own pixels; the winner's attributes come from the face table;
//   * exact culling: a warp skips a listed candidate whose bounding box
//     lies at squared distance >= cull_d2 from the warp's 8 x 4 pixel box.
//     The wrapper passes cull_d2 = max(18 sigma^2, 1) with the silhouette,
//     1 without. At d^2 / sigma^2 >= 18 > 25 ln 2, exp(-x) <= 2^-25 even
//     with expf's 2-ulp error, so 1.f - p rounds to 1.f and the factor
//     changes no bit of keep; beyond 1 px from the box no edge test of a
//     face with nonzero area can pass, its rounding errors being far
//     smaller. A face of zero area (never valid: face_data drops |area| <=
//     1e-10) gets an unbounded box and is never culled;
//   * a warp leaves the loop when all its pixels are covered or outside.
// Registers: 48 (ptxas, sm_90a; no spills), so five 256-thread blocks fit
// an SM. What bounds it on an H100 (chip_smoke.py's graph_ms parts): at the
// DeepIM shapes (512^2, 16 px tiles, 73 % of the tiles empty) the output
// bytes, 40 per pixel (D = 3), written at 1.8 TB/s by stride-3 attr and
// bary stores from 8 x 4 blocks; at the stage-II shapes the silhouette
// terms of the nearby faces (three IEEE divisions and an expf each, kept so
// that keep rounds as the plain version's) and again the output bytes.
//
// Built with --fmad=false so every product and sum rounds as the plain
// PyTorch version's separate operations do: the edge tests then agree
// bitwise on shared edges, and keep bit for bit with the old full loop.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// face-table columns before the 3*D attribute values:
// x0, y0, x1, y1, x2, y2, zmean, valid, 1/z0, 1/z1, 1/z2
constexpr int kGeo = 11;
constexpr int kThreads = 256;
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

// squared distance between the boxes [ax0, ax1] x [ay0, ay1] (pixels) and
// b = (xmin, xmax, ymin, ymax) (a face); raster_cuda.py::box_gap_d2
__device__ __forceinline__ float box_gap_d2(float ax0, float ax1, float ay0,
                                            float ay1, float4 b) {
  const float gx = fmaxf(fmaxf(b.x - ax1, ax0 - b.y), 0.f);
  const float gy = fmaxf(fmaxf(b.z - ay1, ay0 - b.w), 0.f);
  return gx * gx + gy * gy;
}

__global__ void __launch_bounds__(kThreads) fine_raster_fwd_kernel(
    const float* __restrict__ ftab, const int32_t* __restrict__ cand,
    float* __restrict__ mask, float* __restrict__ prob,
    float* __restrict__ depth, float* __restrict__ attr,
    int32_t* __restrict__ face_id, float* __restrict__ bary,
    float* __restrict__ keep_out, int F, int H, int W, int tp, int tw, int Tt,
    int K, int D, float sigma2, float cull_d2, int with_prob, int persp) {
  extern __shared__ float4 smem[];
  float4* s_e01 = smem;                                // K: x0, y0, x1, y1
  float4* s_e2 = s_e01 + K;                            // K: x2, y2, 1/area
  float4* s_box = s_e2 + K;                            // K: bounding box
  int* s_cand = reinterpret_cast<int*>(s_box + K);     // K: face ids
  int* s_near = s_cand + K;                // K: 1 where near the block
  int* s_list = s_near + K;                // K: the near slots, in order
  __shared__ int s_m;

  const int C = kGeo + 3 * D;
  const int nthr = blockDim.x;
  const int P = tp * tp;
  const int S = (P + nthr - 1) / nthr;     // blocks per tile
  const int t = blockIdx.x / S;
  const int b = t / Tt;
  const int ti = t - b * Tt;
  const int lane = threadIdx.x & 31;
  // this thread's pixel: warp w of the tile's pixels takes 8 x 4 block w
  const int q = (blockIdx.x - t * S) * nthr + threadIdx.x;
  const int wb = q >> 5, nbx = tp >> 3;
  const int tx0 = (ti % tw) * tp, ty0 = (ti / tw) * tp;
  const int bx0 = tx0 + (wb % nbx) * 8;
  const int by0 = ty0 + (wb / nbx) * 4;
  const int px = bx0 + (lane & 7);
  const int py = by0 + (lane >> 3);
  const bool in_img = q < P && py < H && px < W;
  const size_t pix = (static_cast<size_t>(b) * H + py) * W + px;
  const int32_t* cand_t = cand + static_cast<size_t>(t) * K;
  const float* ftab_b = ftab + static_cast<size_t>(b) * F * C;

  if (cand_t[0] < 0) {                     // empty tile: uniform, no barrier
    if (!in_img) return;
    mask[pix] = 0.f;
    prob[pix] = 0.f;
    depth[pix] = 0.f;
    face_id[pix] = -1;
    for (int d = 0; d < D; ++d) attr[pix * D + d] = 0.f;
    for (int v = 0; v < 3; ++v) bary[pix * 3 + v] = 0.f;
    if (keep_out) keep_out[pix] = 1.f;
    return;
  }

  // the filled slots (a prefix), and the box of the block's pixels
  int n = 0;
  for (int k0 = 0; k0 < K; k0 += nthr) {
    const int k = k0 + threadIdx.x;
    n += __syncthreads_count(k < K && cand_t[k] >= 0);
  }
  const int w0 = (q - threadIdx.x) >> 5;
  const int w1 = (min(q - threadIdx.x + nthr, P) >> 5) - 1;
  float rx0 = INFINITY, rx1 = -INFINITY, ry0 = INFINITY, ry1 = -INFINITY;
  for (int w = w0; w <= w1; ++w) {
    rx0 = fminf(rx0, static_cast<float>(tx0 + (w % nbx) * 8));
    rx1 = fmaxf(rx1, static_cast<float>(tx0 + (w % nbx) * 8 + 7));
    ry0 = fminf(ry0, static_cast<float>(ty0 + (w / nbx) * 4));
    ry1 = fmaxf(ry1, static_cast<float>(ty0 + (w / nbx) * 4 + 3));
  }

  for (int k = threadIdx.x; k < n; k += nthr) {
    const int f = cand_t[k];
    s_cand[k] = f;
    float r[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (f >= 0)
      for (int j = 0; j < 8; ++j) r[j] = ftab_b[static_cast<size_t>(f) * C + j];
    const float area = (r[2] - r[0]) * (r[5] - r[1]) - (r[4] - r[0]) * (r[3] - r[1]);
    const float inv = fabsf(area) > 1e-12f ? 1.f / area : 0.f;
    float4 box;
    if (!(r[7] > 0.5f)) {                   // empty slot or invalid face
      box = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
    } else if (inv == 0.f) {                // every edge test passes
      box = make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
    } else {
      box = make_float4(fminf(fminf(r[0], r[2]), r[4]),
                        fmaxf(fmaxf(r[0], r[2]), r[4]),
                        fminf(fminf(r[1], r[3]), r[5]),
                        fmaxf(fmaxf(r[1], r[3]), r[5]));
    }
    s_e01[k] = make_float4(r[0], r[1], r[2], r[3]);
    s_e2[k] = make_float4(r[4], r[5], inv, 0.f);
    s_box[k] = box;
    s_near[k] = box_gap_d2(rx0, rx1, ry0, ry1, box) < cull_d2;
  }
  __syncthreads();
  if (threadIdx.x < 32) {                  // list the near slots in order
    int m = 0;
    for (int k0 = 0; k0 < n; k0 += 32) {
      const int k = k0 + lane;
      const bool near = k < n && s_near[k];
      const unsigned bal = __ballot_sync(kFull, near);
      if (near) s_list[m + __popc(bal & ((1u << lane) - 1u))] = k;
      m += __popc(bal);
    }
    if (lane == 0) s_m = m;
  }
  __syncthreads();
  const int m = s_m;

  // a warp past the tile's pixels (tp = 24) leaves whole; the others stay
  // together for the votes below
  if (q >= P) return;
  const float pu = static_cast<float>(px);
  const float pv = static_cast<float>(py);
  const float wx0 = static_cast<float>(bx0), wx1 = static_cast<float>(bx0 + 7);
  const float wy0 = static_cast<float>(by0), wy1 = static_cast<float>(by0 + 3);

  bool done = !in_img;
  int best = -1;
  float bw0 = 0.f, bw1 = 0.f, bw2 = 0.f;
  float keep = 1.f;                        // prod_k (1 - p_k)
  for (int j = 0; j < m; ++j) {
    if (__all_sync(kFull, done)) break;
    const int k = s_list[j];
    if (box_gap_d2(wx0, wx1, wy0, wy1, s_box[k]) >= cull_d2) continue;
    if (done) continue;
    const float4 e01 = s_e01[k], e2 = s_e2[k];
    const float x0 = e01.x, y0 = e01.y, x1 = e01.z, y1 = e01.w;
    const float x2 = e2.x, y2 = e2.y, inv = e2.z;
    const float w0 = ((x1 - pu) * (y2 - pv) - (x2 - pu) * (y1 - pv)) * inv;
    const float w1 = ((x2 - pu) * (y0 - pv) - (x0 - pu) * (y2 - pv)) * inv;
    const float w2 = 1.f - w0 - w1;
    if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
      best = k;                            // the z-test winner (sorted)
      bw0 = w0;
      bw1 = w1;
      bw2 = w2;
      keep = 0.f;                          // keep * (1 - 1)
      done = true;
    } else if (with_prob) {
      const float d2 = fminf(fminf(seg_d2(pu, pv, x0, y0, x1, y1),
                                   seg_d2(pu, pv, x1, y1, x2, y2)),
                             seg_d2(pu, pv, x2, y2, x0, y0));
      keep *= 1.f - expf(-d2 / sigma2);
    }
  }
  if (!in_img) return;
  if (keep_out) keep_out[pix] = keep;

  if (best < 0) {
    mask[pix] = 0.f;
    prob[pix] = with_prob ? 1.f - keep : 0.f;
    depth[pix] = 0.f;
    face_id[pix] = -1;
    for (int d = 0; d < D; ++d) attr[pix * D + d] = 0.f;
    for (int v = 0; v < 3; ++v) bary[pix * 3 + v] = 0.f;
    return;
  }

  float b0 = fminf(fmaxf(bw0, 0.f), 1.f);
  float b1 = fminf(fmaxf(bw1, 0.f), 1.f);
  float b2 = fminf(fmaxf(bw2, 0.f), 1.f);
  const float bs = fmaxf(b0 + b1 + b2, 1e-8f);
  b0 = b0 / bs;
  b1 = b1 / bs;
  b2 = b2 / bs;
  const int f = s_cand[best];
  const float* r = ftab_b + static_cast<size_t>(f) * C;
  float q0, q1, q2, dep;
  if (persp) {
    const float p0 = b0 * __ldg(r + 8), p1 = b1 * __ldg(r + 9);
    const float p2 = b2 * __ldg(r + 10);
    const float s = fmaxf(p0 + p1 + p2, 1e-12f);
    q0 = p0 / s;
    q1 = p1 / s;
    q2 = p2 / s;
    dep = 1.f / s;
  } else {
    q0 = b0;
    q1 = b1;
    q2 = b2;
    dep = __ldg(r + 6);
  }
  const float* a = r + kGeo;
  for (int d = 0; d < D; ++d)
    attr[pix * D + d] = __ldg(a + d) * q0 + __ldg(a + D + d) * q1 +
                        __ldg(a + 2 * D + d) * q2;
  mask[pix] = 1.f;
  prob[pix] = with_prob ? 1.f - keep : 1.f;
  depth[pix] = dep;
  face_id[pix] = f;
  bary[pix * 3 + 0] = b0;
  bary[pix * 3 + 1] = b1;
  bary[pix * 3 + 2] = b2;
}

}  // namespace

// Launches tp^2 / 256 blocks of 256 threads per tile (one block of tp^2
// threads for tp < 16; T = B * Tt tiles, tp a multiple of 8) on `stream`;
// keep_out may be null. Returns cudaGetLastError() after the launch: a
// refused launch never runs and is reported only here.
extern "C" int fine_raster_fwd(const float* ftab, const int32_t* cand,
                               float* mask, float* prob, float* depth,
                               float* attr, int32_t* face_id, float* bary,
                               float* keep_out, int T, int F, int H, int W,
                               int tp, int tw, int Tt, int K, int D,
                               float sigma2, float cull_d2, int with_prob,
                               int persp, void* stream) {
  const int threads = tp * tp < kThreads ? tp * tp : kThreads;
  const size_t smem =
      static_cast<size_t>(K) * (3 * sizeof(float4) + 3 * sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fine_raster_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = T * ((tp * tp + threads - 1) / threads);
  fine_raster_fwd_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      ftab, cand, mask, prob, depth, attr, face_id, bary, keep_out, F, H, W,
      tp, tw, Tt, K, D, sigma2, cull_d2, with_prob, persp);
  return static_cast<int>(cudaGetLastError());
}
