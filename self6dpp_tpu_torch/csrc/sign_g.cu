// The LAB opaque probe's stand-in gradient: out = sign(r - i) * 1e-3,
// elementwise, in float32.
//
// Replaces the two TPU kernels of tools/probes/lab_opaque_probe.py:
//   P1  _sign_kernel  (pallas_g, pallas_call at :68): r, i as (B, n);
//   P2  _sign3_kernel (pallas_g_split, pallas_call at :110): the same on
//       three channel-split (B, S^2) planes of r and of i.
// The plain PyTorch versions are self6dpp_tpu_torch/ops/sign_cuda.py::
// sign_g_plain and sign_g_split_plain.
//
// jnp.sign returns its argument for +-0 and NaN (sign(-0.0) is -0.0), where
// copysign-style code or torch.sign would give +0, so the sign here is
// d > 0 ? 1 : (d < 0 ? -1 : d), times 1e-3f: kernel, plain version and the
// JAX kernel agree bitwise, sign of zero and NaN positions included.
//
// What bounds it: 12 bytes moved per element against four operations (the
// difference, two comparisons, the scale). At the stage-II shapes (B = 8,
// S = 256, 3 channels: 1.57 M elements, 18.9 MB) the bytes set the bound,
// about 5.6 us at 3.35 TB/s. A grid-stride loop, one element per thread
// (P1) or one position of the three planes per thread (P2); neighbouring
// threads touch neighbouring addresses, also in P2, whose planes are
// stride-3 views of one NHWC tensor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sign_scaled(float r, float i) {
  const float d = r - i;
  const float s = d > 0.f ? 1.f : (d < 0.f ? -1.f : d);
  return s * 1e-3f;
}

__global__ void sign_g_kernel(const float* __restrict__ r,
                              const float* __restrict__ i,
                              float* __restrict__ out, int64_t n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < n; k += step) {
    out[k] = sign_scaled(r[k], i[k]);
  }
}

// Six input planes of (B, n), each at its own (batch, element) strides in
// elements; three contiguous (B, n) output planes.
struct Planes {
  const float* in[6];     // r0, r1, r2, i0, i1, i2
  int64_t stride_b[6];
  int64_t stride_n[6];
  float* out[3];
};

__global__ void sign_g_split_kernel(Planes p, int64_t batch, int64_t n) {
  const int64_t total = batch * n;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < total; k += step) {
    const int64_t b = k / n, j = k - b * n;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float r = p.in[c][b * p.stride_b[c] + j * p.stride_n[c]];
      const float i = p.in[3 + c][b * p.stride_b[3 + c] + j * p.stride_n[3 + c]];
      p.out[c][k] = sign_scaled(r, i);
    }
  }
}

int blocks_for(int64_t work) {
  // enough blocks to cover the work, at most 32 per SM of an H100
  const int64_t want = (work + kThreads - 1) / kThreads;
  return static_cast<int>(want < 132 * 32 ? (want > 0 ? want : 1) : 132 * 32);
}

}  // namespace

// P1: out[k] = sign(r[k] - i[k]) * 1e-3 for k < n (contiguous float32), on
// `stream`. Returns cudaGetLastError() after the launch.
extern "C" int sign_g(const float* r, const float* i, float* out, int64_t n,
                      void* stream) {
  sign_g_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      r, i, out, n);
  return static_cast<int>(cudaGetLastError());
}

// P2: out[c][b, j] = sign(r_c[b, j] - i_c[b, j]) * 1e-3 for the three
// channel planes. in: six plane pointers (r0, r1, r2, i0, i1, i2);
// strides: for each, its batch stride then its element stride, in
// elements; out: three contiguous (batch, n) planes.
extern "C" int sign_g_split(const float* const* in, const int64_t* strides,
                            float* const* out, int64_t batch, int64_t n,
                            void* stream) {
  Planes p;
  for (int c = 0; c < 6; ++c) {
    p.in[c] = in[c];
    p.stride_b[c] = strides[2 * c];
    p.stride_n[c] = strides[2 * c + 1];
  }
  for (int c = 0; c < 3; ++c) p.out[c] = out[c];
  sign_g_split_kernel<<<blocks_for(batch * n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p, batch, n);
  return static_cast<int>(cudaGetLastError());
}
