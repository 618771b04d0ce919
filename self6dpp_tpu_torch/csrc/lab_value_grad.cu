// LAB loss value and image gradient in one launch (kernel B3).
//
// Replaces the TPU kernel self6dpp_tpu/ops/lab_pallas.py::_kernel (reached
// through lab_value_grad_pallas, pallas_call in lab_value_grad_pallas). The
// plain PyTorch version of the same function is
// self6dpp_tpu_torch/ops/lab_cuda.py::lab_value_grad_scaled_plain.
//
// For pred and gt (n pixels x 3, NHWC float32) and a mask (n pixels):
//   g_raw[i] = m_i * d|Lab(pred_i) - Lab(gt_i)|_1 / d pred_i    (a, b; + L)
//   out[0]   = sum_i m_i |Lab(pred_i) - Lab(gt_i)|_1 * norm      (the value)
//   out[1]   = weight * norm,   norm = 1 / (max(sum_i m_i, 1) * n_ch)
//   out[2]   the call's block ticket (an unsigned counter)
// through sRGB linearisation -> XYZ -> f(t) (cube root above 0.008856) ->
// Lab, with the JAX kernel's analytic chain. The caller folds out[1] into
// the cotangent add (InjectGrad: ct + g_raw * scale), so the gradient is
// written once and read once.
//
// What bounds it on an H100: 28 bytes read and 12 written per pixel, 21 MB
// at 8 x 256^2 pixels, 6.3 us at 3.35 TB/s. The arithmetic comes close:
// six powers, six cube roots and their derivatives a pixel. Taken with
// libdevice's powf, each behind its own branch, they cost ~800
// instructions a pixel in long dependent chains, and the kernel ran at
// several times the byte bound, bound by issue. The design:
//   * one launch: each block writes its (sum m |dLab|, sum m) partial,
//     fences, and takes a ticket on a counter; the block with the last
//     ticket sums the partials in index order (a fixed tree: the same bits
//     from run to run, no float atomics) and writes out[0] and out[1]. The
//     counter is the call's own (out[2]), zeroed on the launch's stream
//     just before the kernel, so calls on different streams and graph
//     replays never share a ticket.
//   * 4 pixels a thread: each warp walks 128-pixel chunks, staging pred and
//     gt through shared memory with 16-byte loads, neighbouring lanes on
//     neighbouring 16 bytes, and storing the gradient back the same way;
//     the mask is one float4 a lane. The next chunk's loads are issued
//     before the current chunk computes. The grid is 2 blocks an SM (118-126
//     registers a thread). The last 128 pixels, when n is not a multiple of
//     128, take a scalar path. The pointers must be 16-byte aligned (the
//     wrapper checks).
//   * shared transcendentals, no divergent branch: every power and cube
//     root starts from the SFU's log2 and exp2 and takes one Newton step
//     (pow04, cube_root: ~1 ulp, 30 MUFU a pixel instead of libdevice's
//     sequences); dlin reuses lin's power (t^1.4 = u t with u = t^0.4, no
//     second power and no division), df reuses f's inverse cube root (1 /
//     (3 f^2) = s^2 / 3); every constant divisor is a constexpr reciprocal
//     (XYZ_REF, 1.055, 12.92). Both sides of each branch are computed and
//     selected, so the compiler interleaves 12 channel chains a thread.
//     Against the plain version on an H100 (chip_smoke.py phase 5) the
//     value agrees to the bit and the gradient to 8.4e-7 of its largest
//     magnitude (the plain version's own error against float64 is 7.9e-7
//     there, the kernel's 5.7e-7).
// Built with --fmad=false, as every source here: the multiply-adds are the
// explicit __fmaf_rn calls.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // 8 warps, 1,024 pixels a block
constexpr int kWarps = kThreads / 32;
constexpr int kQuad = 4;              // pixels a thread
constexpr int kChunk = 32 * kQuad;    // pixels a warp takes at a time
constexpr int kBlocksPerSm = 2;       // resident blocks the grid is sized to
constexpr float kFt = 0.008856f;      // f(t) threshold
constexpr float kSrgbT = 0.04045f;    // sRGB gamma threshold
constexpr unsigned kFull = 0xffffffffu;
constexpr float kM00 = 0.412453f, kM01 = 0.357580f, kM02 = 0.180423f;
constexpr float kM10 = 0.212671f, kM11 = 0.715160f, kM12 = 0.072169f;
constexpr float kM20 = 0.019334f, kM21 = 0.119193f, kM22 = 0.950227f;
constexpr float kInvRef0 = 1.0f / 0.950456f;   // XYZ_REF[1] is 1
constexpr float kInvRef2 = 1.0f / 1.088754f;
constexpr float kInv1055 = 1.0f / 1.055f;
constexpr float kInv1292 = 1.0f / 12.92f;
constexpr float kF0 = static_cast<float>(16.0 / 116.0);
constexpr float kDlin = static_cast<float>(2.4 / 1.055);
constexpr float kThird = static_cast<float>(1.0 / 3.0);

// The SFU's estimates (abs error ~2^-22 for log2, ~2 ulp for exp2 and the
// reciprocal): each power and root below refines them by a Newton step.
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// u = t^0.4 for t in [0.0365, 1], so that t^2.4 = u t^2 and t^1.4 = u t:
// u0 = exp2(0.4 log2 t) is within ~1e-6; one Newton step on u^5 = t^2,
// u = 0.8 u0 + 0.2 t^2 / u0^4, squares that away and leaves the step's
// roundings (~1 ulp). Outside that range (the linear branch) the result is
// unused and may be NaN.
__device__ __forceinline__ float pow04(float t, float t2) {
  const float u0 = ex2_approx(lg2_approx(t) * 0.4f);
  const float u2 = u0 * u0;
  return __fmaf_rn(0.8f, u0, 0.2f * (t2 * rcp_approx(u2 * u2)));
}

// c^(1/3) for c above kFt, and s2 = c^(-2/3): s = c^(-1/3) from
// exp2(-log2(c) / 3) and one Newton step s + s (1 - c s^3) / 3 (no
// division), then cb = c s^2 and one Newton step on cb, cb + (c - cb^3)
// s^2 / 3 (~1 ulp). Unused and possibly NaN below kFt.
__device__ __forceinline__ float cube_root(float c, float& s2) {
  const float s0 = ex2_approx(lg2_approx(c) * -kThird);
  const float e = __fmaf_rn(-c, s0 * s0 * s0, 1.f);
  const float s = __fmaf_rn(s0 * kThird, e, s0);
  s2 = s * s;
  const float cb = c * s2;
  return __fmaf_rn(__fmaf_rn(-cb * cb, cb, c) * kThird, s2, cb);
}

// sRGB linearisation and its derivative from one power, both branches
// computed and selected (no divergent branch, so the compiler interleaves
// the channels and pixels): with t = (c + 0.055) / 1.055, t^2.4 = u t^2
// and d t^2.4 / dc = (2.4 / 1.055) t^1.4 = (2.4 / 1.055) u t
__device__ __forceinline__ float lin(float c, float& dlin) {
  const float t = (c + 0.055f) * kInv1055, t2 = t * t;
  const float u = pow04(t, t2);
  const bool hi = c > kSrgbT;
  dlin = hi ? kDlin * (u * t) : kInv1292;
  return hi ? u * t2 : c * kInv1292;
}

// f(t) and its derivative from one cube root: above kFt the JAX kernel's
// clamp max(c, 1e-8) is c, and d cbrt(c) / dc = 1 / (3 cbrt(c)^2)
__device__ __forceinline__ float f_lab(float c, float& df) {
  float s2;
  const float cb = cube_root(c, s2);
  const bool hi = c > kFt;
  df = hi ? kThird * s2 : 7.787f;
  return hi ? cb : 7.787f * c + kF0;
}

// a r + b g + c b2, with two fused multiply-adds
__device__ __forceinline__ float mix(float a, float b, float c, float r,
                                     float g, float b2) {
  return __fmaf_rn(c, b2, __fmaf_rn(b, g, a * r));
}

__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

// One pixel: writes m * d|dLab| / d pred to g[0..2], returns m * |dLab|.
template <bool kNoL>
__device__ __forceinline__ float pixel(float pr, float pg, float pb, float gr,
                                       float gg, float gb, float m,
                                       float* g) {
  float dr, dg, db;
  const float rl = lin(pr, dr), gl = lin(pg, dg), bl = lin(pb, db);
  const float x = mix(kM00, kM01, kM02, rl, gl, bl) * kInvRef0;
  const float y = mix(kM10, kM11, kM12, rl, gl, bl);
  const float z = mix(kM20, kM21, kM22, rl, gl, bl) * kInvRef2;
  float dfx, dfy, dfz;
  const float fx = f_lab(x, dfx), fy = f_lab(y, dfy), fz = f_lab(z, dfz);

  // gt's side: the derivatives are not needed (the compiler drops them)
  float unused;
  const float tr = lin(gr, unused), tg = lin(gg, unused), tb = lin(gb, unused);
  const float qx = f_lab(mix(kM00, kM01, kM02, tr, tg, tb) * kInvRef0, unused);
  const float qy = f_lab(mix(kM10, kM11, kM12, tr, tg, tb), unused);
  const float qz = f_lab(mix(kM20, kM21, kM22, tr, tg, tb) * kInvRef2, unused);

  const float da = 500.f * ((fx - fy) - (qx - qy));
  const float dbb = 200.f * ((fy - fz) - (qy - qz));
  float diff = fabsf(da) + fabsf(dbb);
  const float sa = sgn(da), sb = sgn(dbb);
  const float ax = 500.f * sa;
  float ay = -500.f * sa + 200.f * sb;
  const float az = -200.f * sb;
  if (!kNoL) {
    const float dL = 116.f * (fy - qy);
    diff = diff + fabsf(dL);
    ay = ay + 116.f * sgn(dL);
  }
  const float dx = ax * dfx * kInvRef0;
  const float dy = ay * dfy;
  const float dz = az * dfz * kInvRef2;
  g[0] = mix(kM00, kM10, kM20, dx, dy, dz) * dr * m;
  g[1] = mix(kM01, kM11, kM21, dx, dy, dz) * dg * m;
  g[2] = mix(kM02, kM12, kM22, dx, dy, dz) * db * m;
  return diff * m;
}

// (v, m) summed over the block in a fixed order: shuffles within each
// warp, then the warps' sums in order by warp 0
__device__ __forceinline__ float2 block_sum(float2 x, float2* s_warp) {
  for (int o = 16; o > 0; o >>= 1) {
    x.x += __shfl_down_sync(kFull, x.x, o);
    x.y += __shfl_down_sync(kFull, x.y, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) s_warp[warp] = x;
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  if (warp == 0) {
    if (lane < kWarps) s = s_warp[lane];
    for (int o = 16; o > 0; o >>= 1) {
      s.x += __shfl_down_sync(kFull, s.x, o);
      s.y += __shfl_down_sync(kFull, s.y, o);
    }
  }
  return s;                      // valid in thread 0
}

// One chunk's loads: 128 pixels' pred and gt (3 float4 a lane each, the
// warp's 1,536 bytes in order) and the mask (one float4 a lane).
struct Chunk {
  float4 p[3], g[3], m;
};

__device__ __forceinline__ void load_chunk(Chunk& c, const float* pred,
                                           const float* gt, const float* mask,
                                           int chunk, int lane) {
  const float4* p4 = reinterpret_cast<const float4*>(pred) + 96 * chunk;
  const float4* g4 = reinterpret_cast<const float4*>(gt) + 96 * chunk;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c.p[k] = __ldg(p4 + k * 32 + lane);
    c.g[k] = __ldg(g4 + k * 32 + lane);
  }
  c.m = __ldg(reinterpret_cast<const float4*>(mask) + 32 * chunk + lane);
}

template <bool kNoL>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
lab_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
           const float* __restrict__ mask, float* __restrict__ grad,
           float* __restrict__ partial, float* __restrict__ out, int n,
           float weight) {
  // per warp: 96 float4 of pred (then of the gradient) and 96 of gt
  __shared__ float4 s_p[kWarps][96];
  __shared__ float4 s_g[kWarps][96];
  __shared__ float2 s_warp[kWarps];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kWarps + warp, stride = gridDim.x * kWarps;
  const int nfull = n / kChunk;           // chunks of 128 pixels inside n
  float v = 0.f, msum = 0.f;

  // each warp walks its chunks; the next chunk's loads are issued once the
  // current chunk's data is in shared memory, so they are in flight while
  // it computes
  Chunk c;
  if (first < nfull) load_chunk(c, pred, gt, mask, first, lane);
  for (int ch = first; ch < nfull; ch += stride) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s_p[warp][k * 32 + lane] = c.p[k];
      s_g[warp][k * 32 + lane] = c.g[k];
    }
    const float m[4] = {c.m.x, c.m.y, c.m.z, c.m.w};
    __syncwarp();
    if (ch + stride < nfull)
      load_chunk(c, pred, gt, mask, ch + stride, lane);
    // this lane's 4 pixels: 12 floats at 48-byte steps (conflict-free)
    float p[12], t[12], g[12];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float4 a = s_p[warp][3 * lane + j], b = s_g[warp][3 * lane + j];
      p[4 * j] = a.x; p[4 * j + 1] = a.y; p[4 * j + 2] = a.z; p[4 * j + 3] = a.w;
      t[4 * j] = b.x; t[4 * j + 1] = b.y; t[4 * j + 2] = b.z; t[4 * j + 3] = b.w;
    }
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      v += pixel<kNoL>(p[3 * i], p[3 * i + 1], p[3 * i + 2], t[3 * i],
                       t[3 * i + 1], t[3 * i + 2], m[i], g + 3 * i);
      msum += m[i];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
      s_p[warp][3 * lane + j] =
          make_float4(g[4 * j], g[4 * j + 1], g[4 * j + 2], g[4 * j + 3]);
    __syncwarp();
    float4* o4 = reinterpret_cast<float4*>(grad) + 96 * ch;
#pragma unroll
    for (int k = 0; k < 3; ++k) o4[k * 32 + lane] = s_p[warp][k * 32 + lane];
    __syncwarp();
  }
  if (nfull * kChunk < n && first == nfull % stride) {
    // the ragged end (n not a multiple of 128): pixel by pixel, 4 a lane
    const int q = nfull * 32 + lane;
    for (int i = 0; i < kQuad; ++i) {
      const int px = q * kQuad + i;
      if (px >= n) break;
      const float mi = mask[px];
      float g[3];
      v += pixel<kNoL>(pred[3 * px], pred[3 * px + 1], pred[3 * px + 2],
                       gt[3 * px], gt[3 * px + 1], gt[3 * px + 2], mi, g);
      msum += mi;
      grad[3 * px] = g[0];
      grad[3 * px + 1] = g[1];
      grad[3 * px + 2] = g[2];
    }
  }

  const float2 bs = block_sum(make_float2(v, msum), s_warp);
  if (threadIdx.x == 0) {
    reinterpret_cast<float2*>(partial)[blockIdx.x] = bs;
    __threadfence();                       // the partial before the ticket
    s_last = atomicAdd(reinterpret_cast<unsigned*>(out + 2), 1u)
             == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();                         // every partial after the ticket
  float2 t = make_float2(0.f, 0.f);
  for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += kThreads) {
    const float2 x = __ldcg(reinterpret_cast<const float2*>(partial) + j);
    t.x += x.x;
    t.y += x.y;
  }
  const float2 s = block_sum(t, s_warp);
  if (threadIdx.x == 0) {
    const float norm = 1.f / (fmaxf(s.y, 1.f) * (kNoL ? 2.f : 3.f));
    out[0] = s.x * norm;
    out[1] = weight * norm;
  }
}

}  // namespace

// n pixels in 128-pixel chunks, which the warps of min(ceil(n / 1024), 2 x
// the SM count) blocks of 256 threads walk, one launch on `stream` (on the
// current device) after a 4-byte memset of its ticket. partial holds 2 *
// ceil(n / 1024) floats (8-byte aligned), out 3 words. Returns the CUDA
// error of the memset or the launch (0 on success).
extern "C" int lab_value_grad(const float* pred, const float* gt,
                              const float* mask, float* grad, float* partial,
                              float* out, int n, int no_l, float weight,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaMemsetAsync(out + 2, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_block = kWarps * kChunk;
  int nblocks = (n + per_block - 1) / per_block;
  if (nblocks > kBlocksPerSm * sms) nblocks = kBlocksPerSm * sms;
  if (no_l)
    lab_kernel<true><<<nblocks, kThreads, 0, s>>>(pred, gt, mask, grad,
                                                  partial, out, n, weight);
  else
    lab_kernel<false><<<nblocks, kThreads, 0, s>>>(pred, gt, mask, grad,
                                                   partial, out, n, weight);
  return static_cast<int>(cudaGetLastError());
}
