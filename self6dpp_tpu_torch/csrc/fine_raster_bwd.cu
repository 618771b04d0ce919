// Fine stage of the tile-binned rasterizer, backward.
//
// Replaces the TPU kernel self6dpp_tpu/ops/raster_pallas.py::_fine_bwd_kernel
// (reached through fine_raster's custom_vjp -> _fine_bwd_rule, pallas_call in
// _fine_bwd_rule). The plain PyTorch version of the same function is
// self6dpp_tpu_torch/ops/raster_cuda.py::fine_raster_bwd_plain.
//
// Input: the face table and per-tile candidates of the forward (see
// fine_raster_fwd.cu), the forward's saved state (face_id, and keep =
// prod_k (1 - p_k) with the silhouette, both (B, H, W)) and the cotangents
// of prob, depth (B, H, W) and attr (B, H, W, D). Output: d ftab (B, F, C),
// C = 11 + 3D, which the wrapper zero-fills and the kernel adds into.
//
// What it computes, per pixel:
//   * a covered pixel's winner row gets the gradients through the
//     perspective-correct (or affine) barycentrics, the clip-and-renormalise
//     chain with its strict 0 < b < 1 masks and the edge functions and
//     signed area. The winner is the saved face_id; its edge functions are
//     recomputed from its row with the forward's arithmetic, bit for bit;
//   * with the silhouette, a pixel outside every face gives every valid
//     candidate k the gradient of 1 - keep through the leave-one-out
//     product keep / (1 - p_k) (0 where 1 - p_k <= 1e-6) and p_k =
//     exp(-d^2 / sigma^2), d^2 the squared distance to the nearest edge
//     (ties to edge 01, then 12, then 20), with the foot parameter held
//     fixed (envelope theorem). A covered pixel has keep = 0 exactly, so
//     its silhouette terms are 0.
// The z-test is piecewise constant and the `valid` column gets nothing.
//
// Design, one thread per pixel; a warp takes an 8 x 4 block of pixels, a
// block of 256 threads 8 such blocks, so a 32 px tile runs as four blocks
// on up to four SMs (tiles below 16 px: one block of tp^2 threads):
//   * an empty tile (first slot -1: _bin_faces packs the filled slots
//     first, the precondition fine_raster_fwd.cu states) has no covered
//     pixel and returns before any barrier; otherwise the block gathers the
//     tile's candidates' vertices and bounding boxes into shared memory (an
//     invalid face gets an empty box) and lists, in slot order, those
//     within cull_d2 of its own pixels;
//   * winner chain: lanes with the same winner form groups
//     (__match_any_sync); each value is summed within its group by shuffles
//     and the group's first lane adds it to d ftab with one global
//     atomicAdd, instead of every lane adding to the same few addresses;
//   * silhouette, candidate-major: the block's uncovered pixels with a prob
//     cotangent and keep != 0 are compacted into shared memory in a fixed
//     order (per-warp ballots and their prefix), in chunks of 32 with the
//     chunk's pixel box. Warps own the listed candidates, lanes take a
//     chunk's pixels, a warp reduction in a fixed order gives the
//     candidate's six vertex gradients, which lane 0 adds to d ftab: the
//     block's sum is the same from run to run;
//   * exact culling: a block skips a candidate, a warp a (candidate, chunk)
//     pair and a lane a (candidate, pixel) pair whose boxes lie at squared
//     distance >= cull_d2 = 105 sigma^2 (wrapper). At d^2 / sigma^2 >= 105
//     > 150 ln 2, exp(-x) is below half the least subnormal and expf
//     returns exactly 0 (no flush to zero is needed), so p = 0 and every
//     term of the pair is 0;
//   * d ftab is summed with global atomics: its last bits vary from run to
//     run, and it is held against the plain version at a tolerance (so the
//     silhouette may take each edge's inverse squared length once per
//     candidate, where the plain version divides per pixel).
// Registers: 64 (ptxas, sm_90a; 8 bytes spilled), so four 256-thread blocks
// fit an SM. What bounds it on an H100 (chip_smoke.py's graph_ms parts at
// the stage-II shapes): the silhouette pairs of the boundary blocks, each a
// serial chain of three foot parameters, an expf and a division, then the
// prologue (cotangent and state reads, the candidate gather) and the winner
// chain; far from the f32 operation bound.
//
// Built with --fmad=false, like the forward, so the winner's edge
// functions agree bitwise with the forward and the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGeo = 11;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_gap_d2(float ax0, float ax1, float ay0,
                                            float ay1, float4 b) {
  const float gx = fmaxf(fmaxf(b.x - ax1, ax0 - b.y), 0.f);
  const float gy = fmaxf(fmaxf(b.z - ay1, ay0 - b.w), 0.f);
  return gx * gx + gy * gy;
}

// Sum of a value over each group of lanes with the same key: after
// build(), sum(v) returns the group's total at the group's first lane
// (`leader`). At most five shuffle steps, each lane adding the partial sum
// of the next peer of its group at rank distance 2^s.
struct PeerSum {
  int steps;
  int src[5];
  unsigned add;
  bool leader;

  __device__ __forceinline__ void build(int key, int lane) {
    unsigned peers = __match_any_sync(kFull, key);
    leader = (__ffs(peers) - 1) == lane;
    int rank = __popc(peers & ((1u << lane) - 1u));
    peers &= 0xfffffffeu << lane;            // peers above this lane
    steps = 0;
    add = 0u;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      if (!__any_sync(kFull, peers)) break;
      const int next = __ffs(peers);
      src[s] = next ? next - 1 : lane;
      if (next && !(rank & 1)) add |= 1u << s;
      peers &= __ballot_sync(kFull, !(rank & 1));
      rank >>= 1;
      steps = s + 1;
    }
  }

  __device__ __forceinline__ float sum(float v) const {
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      if (s < steps) {
        const float o = __shfl_sync(kFull, v, src[s]);
        if (add >> s & 1u) v += o;
      }
    }
    return v;
  }
};

__device__ __forceinline__ void add_to(float* row, int col, float v, bool on) {
  if (on && v != 0.f) atomicAdd(row + col, v);
}

__global__ void __launch_bounds__(kThreads) fine_raster_bwd_kernel(
    const float* __restrict__ ftab, const int32_t* __restrict__ cand,
    const int32_t* __restrict__ face_id, const float* __restrict__ keep,
    const float* __restrict__ dprob, const float* __restrict__ ddepth,
    const float* __restrict__ dattr, float* __restrict__ dftab, int F, int H,
    int W, int tp, int tw, int Tt, int K, int D, float sigma2, float cull_d2,
    int with_prob, int persp) {
  extern __shared__ float4 smem[];
  float4* s_e01 = smem;                                 // K: x0, y0, x1, y1
  float4* s_box = s_e01 + K;                            // K: bounding box
  float2* s_e2 = reinterpret_cast<float2*>(s_box + K);  // K: x2, y2
  int* s_cand = reinterpret_cast<int*>(s_e2 + K);       // K: face ids
  int* s_near = s_cand + K;                // K: 1 where near the block
  int* s_list = s_near + K;                // K: the near slots
  __shared__ int s_m;
  __shared__ int s_off[kThreads / 32 + 1];              // per warp
  __shared__ float4 s_pix[kThreads];                    // u, v, dprob, keep
  __shared__ float4 s_cbox[kThreads / 32];              // per chunk of 32

  const int C = kGeo + 3 * D;
  const int nthr = blockDim.x;
  const int P = tp * tp;
  const int S = (P + nthr - 1) / nthr;     // blocks per tile
  const int t = blockIdx.x / S;
  const int b = t / Tt;
  const int ti = t - b * Tt;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = nthr >> 5;
  // this thread's pixel: warp w of the tile's pixels takes 8 x 4 block w;
  // a warp past the tile's pixels (tp = 24) idles whole
  const int q = (blockIdx.x - t * S) * nthr + threadIdx.x;
  const int wb = q >> 5, nbx = tp >> 3;
  const int tx0 = (ti % tw) * tp, ty0 = (ti / tw) * tp;
  const int px = tx0 + (wb % nbx) * 8 + (lane & 7);
  const int py = ty0 + (wb / nbx) * 4 + (lane >> 3);
  const bool in_img = q < P && py < H && px < W;
  const size_t pix = in_img ? (static_cast<size_t>(b) * H + py) * W + px : 0;
  const float pu = static_cast<float>(px);
  const float pv = static_cast<float>(py);
  const int32_t* cand_t = cand + static_cast<size_t>(t) * K;
  const float* ftab_b = ftab + static_cast<size_t>(b) * F * C;
  float* dftab_b = dftab + static_cast<size_t>(b) * F * C;

  // an empty tile (first slot -1: _bin_faces packs the filled slots
  // first) has no covered pixel and no silhouette: uniform, no barrier
  if (cand_t[0] < 0) return;
  int n = 0;                                // the filled slots (a prefix)
  for (int k0 = 0; k0 < K; k0 += nthr) {
    const int k = k0 + threadIdx.x;
    n += __syncthreads_count(k < K && cand_t[k] >= 0);
  }
  // the box of the block's pixels
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
    s_e01[k] = make_float4(r[0], r[1], r[2], r[3]);
    s_e2[k] = make_float2(r[4], r[5]);
    s_box[k] = r[7] > 0.5f
        ? make_float4(fminf(fminf(r[0], r[2]), r[4]),
                      fmaxf(fmaxf(r[0], r[2]), r[4]),
                      fminf(fminf(r[1], r[3]), r[5]),
                      fmaxf(fmaxf(r[1], r[3]), r[5]))
        : make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
    s_near[k] = box_gap_d2(rx0, rx1, ry0, ry1, s_box[k]) < cull_d2;
  }

  // the winner chain; each warp also counts its silhouette pixels
  const int fid = in_img ? face_id[pix] : -1;
  float dP = 0.f, kp = 0.f;
  bool sil = false;
  if (with_prob && fid < 0 && in_img) {
    dP = dprob[pix];
    kp = keep[pix];
    sil = dP != 0.f && kp != 0.f;
  }
  const unsigned sil_bal = __ballot_sync(kFull, sil);
  if (lane == 0) s_off[warp] = __popc(sil_bal);
  const float* da = dattr + pix * D;
  bool act = false;                         // a winner with a cotangent
  float dd = 0.f;
  if (fid >= 0) {
    dd = ddepth[pix];
    act = dd != 0.f;
    for (int d = 0; d < D && !act; ++d) act = da[d] != 0.f;
  }
  if (__any_sync(kFull, act)) {             // uniform across the warp
    PeerSum ps;
    ps.build(act ? fid : -1, lane);
    const bool lead = act && ps.leader;     // a group with a cotangent
    float* g = dftab_b + static_cast<size_t>(act ? fid : 0) * C;
    const float* r = ftab_b + static_cast<size_t>(act ? fid : 0) * C;

    const float x0 = __ldg(r + 0), y0 = __ldg(r + 1), x1 = __ldg(r + 2);
    const float y1 = __ldg(r + 3), x2 = __ldg(r + 4), y2 = __ldg(r + 5);
    const float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
    const float inv = fabsf(area) > 1e-12f ? 1.f / area : 0.f;
    const float be0 = (x1 - pu) * (y2 - pv) - (x2 - pu) * (y1 - pv);
    const float be1 = (x2 - pu) * (y0 - pv) - (x0 - pu) * (y2 - pv);
    const float bw0 = be0 * inv;
    const float bw1 = be1 * inv;
    const float bw2 = 1.f - bw0 - bw1;
    const float c0 = fminf(fmaxf(bw0, 0.f), 1.f);
    const float c1 = fminf(fmaxf(bw1, 0.f), 1.f);
    const float c2 = fminf(fmaxf(bw2, 0.f), 1.f);
    const float bs = fmaxf(c0 + c1 + c2, 1e-8f);
    const float b0 = c0 / bs, b1 = c1 / bs, b2 = c2 / bs;
    const float* a = r + kGeo;
    float db0, db1, db2;
    if (persp) {
      const float z0 = __ldg(r + 8), z1 = __ldg(r + 9), z2 = __ldg(r + 10);
      const float p0 = b0 * z0, p1 = b1 * z1, p2 = b2 * z2;
      const float s = fmaxf(p0 + p1 + p2, 1e-12f);
      const float q0 = p0 / s, q1 = p1 / s, q2 = p2 / s;
      float dq0 = 0.f, dq1 = 0.f, dq2 = 0.f;
      for (int d = 0; d < D; ++d) {
        const float gd = act ? da[d] : 0.f;
        dq0 += __ldg(a + d) * gd;
        dq1 += __ldg(a + D + d) * gd;
        dq2 += __ldg(a + 2 * D + d) * gd;
        add_to(g, kGeo + d, ps.sum(q0 * gd), lead);
        add_to(g, kGeo + D + d, ps.sum(q1 * gd), lead);
        add_to(g, kGeo + 2 * D + d, ps.sum(q2 * gd), lead);
      }
      const float mixq = q0 * dq0 + q1 * dq1 + q2 * dq2;
      const float ds_extra = -dd / (s * s);
      const float dp0 = (dq0 - mixq) / s + ds_extra;
      const float dp1 = (dq1 - mixq) / s + ds_extra;
      const float dp2 = (dq2 - mixq) / s + ds_extra;
      db0 = dp0 * z0;
      db1 = dp1 * z1;
      db2 = dp2 * z2;
      add_to(g, 8, ps.sum(act ? dp0 * b0 : 0.f), lead);
      add_to(g, 9, ps.sum(act ? dp1 * b1 : 0.f), lead);
      add_to(g, 10, ps.sum(act ? dp2 * b2 : 0.f), lead);
    } else {
      db0 = db1 = db2 = 0.f;
      for (int d = 0; d < D; ++d) {
        const float gd = act ? da[d] : 0.f;
        db0 += __ldg(a + d) * gd;
        db1 += __ldg(a + D + d) * gd;
        db2 += __ldg(a + 2 * D + d) * gd;
        add_to(g, kGeo + d, ps.sum(b0 * gd), lead);
        add_to(g, kGeo + D + d, ps.sum(b1 * gd), lead);
        add_to(g, kGeo + 2 * D + d, ps.sum(b2 * gd), lead);
      }
      add_to(g, 6, ps.sum(dd), lead);
    }
    const float mix = b0 * db0 + b1 * db1 + b2 * db2;
    const float dc0 = (bw0 > 0.f && bw0 < 1.f) ? (db0 - mix) / bs : 0.f;
    const float dc1 = (bw1 > 0.f && bw1 < 1.f) ? (db1 - mix) / bs : 0.f;
    const float dc2 = (bw2 > 0.f && bw2 < 1.f) ? (db2 - mix) / bs : 0.f;
    const float dw0 = dc0 - dc2;             // w2 = 1 - w0 - w1
    const float dw1 = dc1 - dc2;
    const float de0 = dw0 * inv;
    const float de1 = dw1 * inv;
    const float darea = -(dw0 * be0 + dw1 * be1) * inv * inv;
    const float v0 = -de1 * (y2 - pv) + darea * (y1 - y2);
    const float v1 = de1 * (x2 - pu) + darea * (x2 - x1);
    const float v2 = de0 * (y2 - pv) + darea * (y2 - y0);
    const float v3 = -de0 * (x2 - pu) - darea * (x2 - x0);
    const float v4 = -de0 * (y1 - pv) + de1 * (y0 - pv) - darea * (y1 - y0);
    const float v5 = de0 * (x1 - pu) - de1 * (x0 - pu) + darea * (x1 - x0);
    add_to(g, 0, ps.sum(act ? v0 : 0.f), lead);
    add_to(g, 1, ps.sum(act ? v1 : 0.f), lead);
    add_to(g, 2, ps.sum(act ? v2 : 0.f), lead);
    add_to(g, 3, ps.sum(act ? v3 : 0.f), lead);
    add_to(g, 4, ps.sum(act ? v4 : 0.f), lead);
    add_to(g, 5, ps.sum(act ? v5 : 0.f), lead);
  }
  if (!with_prob) return;                   // uniform
  __syncthreads();                          // s_off counts, candidates
  if (warp == nwarps - 1) {                // list the near slots
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

  // exclusive prefix of the per-warp counts
  if (warp == 0) {
    const int c = lane < nwarps ? s_off[lane] : 0;
    int x = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane < nwarps) s_off[lane] = x - c;
    if (lane == 31) s_off[nwarps] = x;       // total
  }
  __syncthreads();
  const int nsil = s_off[nwarps];
  if (nsil == 0) return;                    // uniform

  // compact the silhouette pixels in warp order
  if (sil)
    s_pix[s_off[warp] + __popc(sil_bal & ((1u << lane) - 1u))] =
        make_float4(pu, pv, dP, kp);
  __syncthreads();
  const int nchunk = (nsil + 31) >> 5;
  for (int c = warp; c < nchunk; c += nwarps) {
    const int i = (c << 5) + lane;
    const float4 p = s_pix[i < nsil ? i : nsil - 1];
    const int u = static_cast<int>(p.x), v = static_cast<int>(p.y);
    const int u0 = __reduce_min_sync(kFull, u);
    const int u1 = __reduce_max_sync(kFull, u);
    const int v0 = __reduce_min_sync(kFull, v);
    const int v1 = __reduce_max_sync(kFull, v);
    if (lane == 0)
      s_cbox[c] = make_float4(static_cast<float>(u0), static_cast<float>(u1),
                              static_cast<float>(v0), static_cast<float>(v1));
  }
  __syncthreads();

  // candidate-major: warps own the near candidates, lanes take a chunk's
  // pixels. Each edge's foot parameter uses its inverse squared length, and
  // the gradient reuses the nearest edge's foot and residual: B2 is held at
  // a tolerance, only B1 must round as the plain version does.
  const int m = s_m;
  const float ninv_s2 = -1.f / sigma2;
  for (int j = warp; j < m; j += nwarps) {
    const int k = s_list[j];
    const float4 box = s_box[k];
    const float4 e01 = s_e01[k];
    const float2 e2 = s_e2[k];
    const float vx[3] = {e01.x, e01.z, e2.x};
    const float vy[3] = {e01.y, e01.w, e2.y};
    float ex[3], ey[3], il[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      ex[e] = vx[(e + 1) % 3] - vx[e];
      ey[e] = vy[(e + 1) % 3] - vy[e];
      il[e] = 1.f / fmaxf(ex[e] * ex[e] + ey[e] * ey[e], 1e-12f);
    }
    float g[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    bool any = false;
    for (int c = 0; c < nchunk; ++c) {
      const float4 cb = s_cbox[c];
      if (box_gap_d2(cb.x, cb.y, cb.z, cb.w, box) >= cull_d2) continue;
      const int i = (c << 5) + lane;
      if (i >= nsil) continue;
      const float4 p = s_pix[i];
      if (box_gap_d2(p.x, p.x, p.y, p.y, box) >= cull_d2) continue;
      float best_d2 = 0.f, bt = 0.f, brx = 0.f, bry = 0.f;
      int be = 0;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float apx = p.x - vx[e], apy = p.y - vy[e];
        const float dot = (apx * ex[e] + apy * ey[e]) * il[e];
        const float tt = fminf(fmaxf(dot, 0.f), 1.f);
        const float rx = apx - tt * ex[e], ry = apy - tt * ey[e];
        const float d2 = rx * rx + ry * ry;
        // ties to edge 01, then 12, then 20
        if (e == 0 || d2 < best_d2) {
          best_d2 = d2;
          bt = tt;
          brx = rx;
          bry = ry;
          be = e;
        }
      }
      const float pk = expf(best_d2 * ninv_s2);
      const float one_m = 1.f - pk;
      if (!(one_m > 1e-6f)) continue;       // leave-one-out factor 0
      const float dd2 = pk * ninv_s2 * (p.z * (p.w / one_m));
      if (dd2 == 0.f) continue;
      any = true;
      const float ga = -2.f * dd2;
      const float gax = ga * brx * (1.f - bt), gay = ga * bry * (1.f - bt);
      const float gbx = ga * brx * bt, gby = ga * bry * bt;
      // edge e runs from vertex e to vertex (e + 1) % 3
      const int ia = 2 * be, ib = be == 2 ? 0 : 2 * be + 2;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        if (2 * v == ia) {
          g[2 * v] += gax;
          g[2 * v + 1] += gay;
        } else if (2 * v == ib) {
          g[2 * v] += gbx;
          g[2 * v + 1] += gby;
        }
      }
    }
    if (!__any_sync(kFull, any)) continue;
    float* gr = dftab_b + static_cast<size_t>(s_cand[k]) * C;
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) {
      float v = g[jj];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      add_to(gr, jj, v, lane == 0);
    }
  }
}

}  // namespace

// Launches tp^2 / 256 blocks of 256 threads per tile (one block of tp^2
// threads for tp < 16; T = B * Tt tiles, tp a multiple of 8) on `stream`;
// keep may be null without the silhouette. dftab must hold zeros (or a sum
// to add to). Returns cudaGetLastError() after the launch.
extern "C" int fine_raster_bwd(const float* ftab, const int32_t* cand,
                               const int32_t* face_id, const float* keep,
                               const float* dprob, const float* ddepth,
                               const float* dattr, float* dftab, int T, int F,
                               int H, int W, int tp, int tw, int Tt, int K,
                               int D, float sigma2, float cull_d2,
                               int with_prob, int persp, void* stream) {
  const size_t smem = static_cast<size_t>(K) *
      (2 * sizeof(float4) + sizeof(float2) + 3 * sizeof(int));
  constexpr size_t kStatic = sizeof(float4) * (kThreads + kThreads / 32) +
                             sizeof(int) * (kThreads / 32 + 2);
  if (smem + kStatic > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fine_raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = tp * tp < kThreads ? tp * tp : kThreads;
  const int blocks = T * ((tp * tp + threads - 1) / threads);
  fine_raster_bwd_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      ftab, cand, face_id, keep, dprob, ddepth, dattr, dftab, F, H, W, tp, tw,
      Tt, K, D, sigma2, cull_d2, with_prob, persp);
  return static_cast<int>(cudaGetLastError());
}
