// LAB loss value and image gradient in one pass.
//
// Replaces the TPU kernel self6dpp_tpu/ops/lab_pallas.py::_kernel (reached
// through lab_value_grad_pallas, pallas_call in lab_value_grad_pallas). The
// plain PyTorch version of the same function is
// self6dpp_tpu_torch/ops/lab_cuda.py::lab_value_grad_plain.
//
// For pred and gt (n pixels x 3, NHWC float32) and a mask (n pixels):
//   grad[i]   = m_i * d|Lab(pred_i) - Lab(gt_i)|_1 / d pred_i    (a, b; + L)
//   sums[0]   = sum_i m_i |Lab(pred_i) - Lab(gt_i)|_1,  sums[1] = sum_i m_i
// through sRGB linearisation -> XYZ -> f(t) (cube root above 0.008856) ->
// Lab, with the JAX kernel's analytic chain. The normalisation by
// max(sums[1], 1) * n_ch stays with the caller, as in the JAX package.
//
// The Pallas grid runs in order and adds into SMEM scalars; a CUDA grid runs
// in parallel, so the sums are taken in two launches: each block of the
// first sums its pixels in a fixed tree (warp shuffles, then the warps in
// order) into partial[block]; one block of the second sums the partials in
// a fixed order. No float atomics: the value is the same bitwise from run to
// run. The cube root is cbrtf (the JAX kernel's exp(log(c)/3) stands in for
// a cube root Mosaic lacks).
//
// What bounds it: 28 bytes read and 12 written per pixel, against ~150 f32
// operations (two pow, six cbrt, the 3x3 mixes) per pixel; at 8 x 256^2
// pixels the bytes set the bound (21 MB in ~6 us) only if the ~20
// transcendental calls a pixel needs keep pace. One thread per pixel with
// coalesced loads of its three channels; the reduction is a few hundred
// bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr float kFt = 0.008856f;      // f(t) threshold
constexpr float kSrgbT = 0.04045f;    // sRGB gamma threshold
constexpr unsigned kFull = 0xffffffffu;
__constant__ float kM[3][3] = {{0.412453f, 0.357580f, 0.180423f},
                               {0.212671f, 0.715160f, 0.072169f},
                               {0.019334f, 0.119193f, 0.950227f}};
__constant__ float kRef[3] = {0.950456f, 1.0f, 1.088754f};

__device__ __forceinline__ float lin(float c) {
  return c > kSrgbT ? powf((c + 0.055f) / 1.055f, 2.4f) : c / 12.92f;
}

__device__ __forceinline__ float dlin(float c) {
  return c > kSrgbT
             ? static_cast<float>(2.4 / 1.055) * powf((c + 0.055f) / 1.055f, 1.4f)
             : static_cast<float>(1.0 / 12.92);
}

__device__ __forceinline__ float f_lab(float c) {
  return c > kFt ? cbrtf(fmaxf(c, kEps))
                 : 7.787f * c + static_cast<float>(16.0 / 116.0);
}

// d cbrt(max(c, eps)) / dc = 1 / (3 cbrt(c)^2) above eps, 0 below
__device__ __forceinline__ float df_lab(float c) {
  const float cb = cbrtf(fmaxf(c, kEps));
  const float dcbrt = c > kEps ? 1.f / (3.f * cb * cb) : 0.f;
  return c > kFt ? dcbrt : 7.787f;
}

__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

struct Lab {
  float x, y, z, L, a, b;
};

__device__ __forceinline__ Lab to_lab(float r, float g, float b) {
  const float rl = lin(r), gl = lin(g), bl = lin(b);
  Lab o;
  o.x = (kM[0][0] * rl + kM[0][1] * gl + kM[0][2] * bl) / kRef[0];
  o.y = (kM[1][0] * rl + kM[1][1] * gl + kM[1][2] * bl) / kRef[1];
  o.z = (kM[2][0] * rl + kM[2][1] * gl + kM[2][2] * bl) / kRef[2];
  const float fx = f_lab(o.x), fy = f_lab(o.y), fz = f_lab(o.z);
  o.L = 116.f * fy - 16.f;
  o.a = 500.f * (fx - fy);
  o.b = 200.f * (fy - fz);
  return o;
}

// sum over the block in a fixed order: shuffles within each warp, then the
// warps' sums in order by warp 0
__device__ __forceinline__ float block_sum(float v, float* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = lane < nwarps ? s_warp[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
  }
  return s;                      // valid in thread 0
}

__global__ void lab_pixels_kernel(const float* __restrict__ pred,
                                  const float* __restrict__ gt,
                                  const float* __restrict__ mask,
                                  float* __restrict__ grad,
                                  float* __restrict__ partial, int n,
                                  int no_l) {
  __shared__ float s_warp[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.f, msum = 0.f;
  if (i < n) {
    const float pr = pred[3 * i], pg = pred[3 * i + 1], pb = pred[3 * i + 2];
    const float m = mask[i];
    const Lab p = to_lab(pr, pg, pb);
    const Lab g = to_lab(gt[3 * i], gt[3 * i + 1], gt[3 * i + 2]);
    float diff = fabsf(p.a - g.a) + fabsf(p.b - g.b);
    const float sa = sgn(p.a - g.a), sb = sgn(p.b - g.b);
    const float dfx = 500.f * sa;
    float dfy = -500.f * sa + 200.f * sb;
    const float dfz = -200.f * sb;
    if (!no_l) {
      diff = diff + fabsf(p.L - g.L);
      dfy = dfy + 116.f * sgn(p.L - g.L);
    }
    const float dx = dfx * df_lab(p.x) / kRef[0];
    const float dy = dfy * df_lab(p.y) / kRef[1];
    const float dz = dfz * df_lab(p.z) / kRef[2];
    grad[3 * i] = (dx * kM[0][0] + dy * kM[1][0] + dz * kM[2][0]) * dlin(pr) * m;
    grad[3 * i + 1] = (dx * kM[0][1] + dy * kM[1][1] + dz * kM[2][1]) * dlin(pg) * m;
    grad[3 * i + 2] = (dx * kM[0][2] + dy * kM[1][2] + dz * kM[2][2]) * dlin(pb) * m;
    v = diff * m;
    msum = m;
  }
  const float bv = block_sum(v, s_warp);
  const float bm = block_sum(msum, s_warp);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = bv;
    partial[2 * blockIdx.x + 1] = bm;
  }
}

__global__ void lab_reduce_kernel(const float* __restrict__ partial,
                                  int nblocks, float* __restrict__ sums) {
  __shared__ float s_warp[32];
  float v = 0.f, m = 0.f;
  for (int j = threadIdx.x; j < nblocks; j += blockDim.x) {
    v += partial[2 * j];
    m += partial[2 * j + 1];
  }
  const float bv = block_sum(v, s_warp);
  const float bm = block_sum(m, s_warp);
  if (threadIdx.x == 0) {
    sums[0] = bv;
    sums[1] = bm;
  }
}

}  // namespace

// n pixels in blocks of 256 threads (nblocks = ceil(n / 256)), then one block
// of 1024 threads for the partials, both on `stream`. Returns
// cudaGetLastError() after the launches.
extern "C" int lab_value_grad(const float* pred, const float* gt,
                              const float* mask, float* grad, float* partial,
                              float* sums, int n, int nblocks, int no_l,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  lab_pixels_kernel<<<nblocks, 256, 0, s>>>(pred, gt, mask, grad, partial, n,
                                            no_l);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lab_reduce_kernel<<<1, 1024, 0, s>>>(partial, nblocks, sums);
  return static_cast<int>(cudaGetLastError());
}
