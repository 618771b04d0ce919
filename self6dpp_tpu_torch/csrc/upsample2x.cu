// The GDR-Net geo head's bilinear 2x upsample with align_corners=True, on
// NCHW-contiguous bfloat16 or float32 planes: the forward and its backward.
//
// Replaces no Pallas kernel: the JAX package leaves its upsample,
// self6dpp_tpu/models/layers.py::_resize_align_corners, to XLA's gathers.
// It was added because the port's plain version (models/layers.py::
// upsample2x_align_corners_plain, eight advanced-index gathers and their
// lerps) puts its backward into PyTorch's sort-based index_put: 91 ms of the
// ~400 ms 128-ROI stage-II step on an H100 went to
// indexing_backward_kernel_stride_1 alone (PERF.md, section 5).
//
// What bounds it: one read of the input and one write of the output, or
// the other way round in the backward. At the stage-II step's second
// upsample, (128, 256, 32, 32) -> (128, 256, 64, 64) in bf16, that is
// 67 MB + 268 MB, 0.10 ms at 3.35 TB/s; the first, from 16^2, is a quarter
// of it. The step itself, under bf16 autocast, hands it float32 (the head's
// GroupNorm runs in float32): 134 + 537 MB, 0.20 ms. The arithmetic (six
// products, three sums an output) is far below.
//
// Design. The index and weight tables come from the host
// (models/layers.py::upsample_tables: torch.linspace's values, which fill
// their second half from the end point, so no formula here recomputes
// them). Each block owns one band of rows of one plane. It first copies the
// source rows the band reads into shared memory, 16 bytes a load and four
// loads in flight a thread, so that every global byte is read once and the
// block waits on one round of load latency; then two passes in shared
// memory:
//   forward   A: the band's input rows interpolated along W,
//                hx[r][ox] = T(T(x[r][x0] * (1 - wx)) + T(x[r][x1] * wx)),
//                which is the plain version's `top` (r = y0) and `bot`
//                (r = y1) exactly;
//             B: out[oy][ox] = T(T(hx[y0] * (1 - wy)) + T(hx[y1] * wy)),
//                each thread a run of 16 bytes of one output row, stored
//                with one 16-byte store.
//   T() rounds to the working type after every operation, in the plain
//   order, and the build passes --fmad=false, so the output is bitwise the
//   plain function's on the card.
//   backward  in gather form, with no atomics and no sort: through the
//             per-axis inverse tables (for input index i, the outputs o
//             that read it and the rounded weight each applied, 1 - w or
//             w), A: gx[oy][ix] = sum_k g[oy][ox_k] * wx_k for the band's
//             output rows; B: gin[iy][ix] = sum_k gx[oy_k][ix] * wy_k, a
//             16-byte run of one input row per thread. Float32 throughout,
//             rounded once; the order of the sums is fixed, so the result
//             is deterministic (and equals the plain twin,
//             models/layers.py::upsample2x_align_corners_bwd_plain, which
//             sums in the same order).
// Both launch on the caller's stream, allocate nothing and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// entries of an inverse table row: at every size an input is read by at
// most 5 (output, weight) pairs (4 inside, 5 at the second, the clamped end
// twice at the last); sized to that, the backward takes fewer registers (at
// most 43, against 54 at 8) and more of its blocks share an SM
constexpr int kMaxTaps = 5;
constexpr int kSmemDefault = 48 * 1024;

// round to the working type, as each separate PyTorch operation does
__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__device__ __forceinline__ float rd(float v) { return rnd(v, T()); }

// V floats from shared memory, 16 bytes at a time when V allows
template <int V>
__device__ __forceinline__ void load_v(const float* p, float* v) {
  if (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      v[j] = f.x; v[j + 1] = f.y; v[j + 2] = f.z; v[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = p[j];
  }
}

// V values of the working type from float, stored as 16 bytes
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162 h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  u.x = *reinterpret_cast<unsigned*>(&h[0]);
  u.y = *reinterpret_cast<unsigned*>(&h[1]);
  u.z = *reinterpret_cast<unsigned*>(&h[2]);
  u.w = *reinterpret_cast<unsigned*>(&h[3]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One axis of the forward: out index o reads inputs i0[o] (weight omw[o],
// 1 - w rounded to the working type) and i1[o] (weight w[o]).
struct FwdAxis {
  const int* i0;
  const int* i1;
  const float* omw;
  const float* w;
};

// One axis of the backward: input i is read by outputs o[i * k + j] with
// weights w[i * k + j], j < n[i], in ascending order of the output.
struct BwdAxis {
  const int* o;
  const float* w;
  const int* n;
  int k;
};

// Threads of a block as `groups` groups of `lanes` lanes: lane l walks
// columns l, l + lanes, ...; group g walks rows g, g + groups, ...
struct Lanes {
  int lanes, groups, lane, group;
  __device__ Lanes(int cols) {
    lanes = cols < static_cast<int>(blockDim.x) ? cols : blockDim.x;
    groups = blockDim.x / lanes;
    lane = threadIdx.x % lanes;
    group = threadIdx.x / lanes;
  }
};

// The first float of a block's shared memory after `floats` floats, for a
// staged slab of the source: 16-byte aligned.
__device__ __forceinline__ int slab_offset(int floats) {
  return (floats + 3) & ~3;
}

// Copies n elements from global src to shared dst (16-byte aligned), every
// thread of the block taking part: 16 bytes a load, four loads in flight a
// thread, where src and n allow; else one element at a time.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int n) {
  const int bd = blockDim.x;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      (n * sizeof(T)) % 16 == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const int n16 = static_cast<int>(n * sizeof(T) / 16);
    int i = threadIdx.x;
    for (; i + 3 * bd < n16; i += 4 * bd) {
      const uint4 a = __ldg(s + i), b = __ldg(s + i + bd),
                  c = __ldg(s + i + 2 * bd), e = __ldg(s + i + 3 * bd);
      d[i] = a; d[i + bd] = b; d[i + 2 * bd] = c; d[i + 3 * bd] = e;
    }
    for (; i < n16; i += bd) d[i] = __ldg(s + i);
  } else {
    for (int i = threadIdx.x; i < n; i += bd) dst[i] = src[i];
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// grid: planes * bands blocks; a band is band_rows output rows, which read
// at most smem_rows input rows.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
upsample2x_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, int h,
                      int w, int bands, int band_rows, int smem_rows,
                      FwdAxis ya, FwdAxis xa) {
  extern __shared__ __align__(16) float smem[];
  const int w2 = 2 * w;
  float* hx = smem;                  // the band's input rows along W, x 2w
  T* slab = reinterpret_cast<T*>(smem + slab_offset(smem_rows * w2));
  const int64_t plane = blockIdx.x / bands;
  const int band = blockIdx.x - static_cast<int>(plane * bands);
  const int r0 = band * band_rows;
  const int r1 = min(r0 + band_rows, 2 * h);
  const int lo = ya.i0[r0];
  const int rows = ya.i1[r1 - 1] - lo + 1;
  stage(slab, x + (plane * h + lo) * w, rows * w);
  __syncthreads();

  // A: interpolate the band's input rows along W
  {
    const Lanes t(w2);
    if (t.group < t.groups) {
      for (int ox = t.lane; ox < w2; ox += t.lanes) {
        const int c0 = xa.i0[ox], c1 = xa.i1[ox];
        const float p = xa.omw[ox], q = xa.w[ox];
        for (int r = t.group; r < rows; r += t.groups) {
          const T* row = slab + r * w;
          hx[r * w2 + ox] = rd<T>(rd<T>(to_f(row[c0]) * p) +
                                  rd<T>(to_f(row[c1]) * q));
        }
      }
    }
  }
  __syncthreads();

  // B: interpolate along H, V adjacent outputs of one row per thread
  T* op = out + (plane * 2 * h + r0) * static_cast<int64_t>(w2);
  const int runs = w2 / V;
  const Lanes t(runs);
  if (t.group >= t.groups) return;
  for (int r = t.group; r < r1 - r0; r += t.groups) {
    const int oy = r0 + r;
    const float* top = hx + (ya.i0[oy] - lo) * w2;
    const float* bot = hx + (ya.i1[oy] - lo) * w2;
    const float p = ya.omw[oy], q = ya.w[oy];
    for (int c = t.lane; c < runs; c += t.lanes) {
      const int ox = c * V;
      float a[V], b[V], v[V];
      load_v<V>(top + ox, a);
      load_v<V>(bot + ox, b);
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[j] = rd<T>(rd<T>(a[j] * p) + rd<T>(b[j] * q));
      if (V == 1) {
        store1(op + static_cast<int64_t>(r) * w2 + ox, v[0]);
      } else {
        store16(op + static_cast<int64_t>(r) * w2 + ox, v);
      }
    }
  }
}

// grid: planes * bands blocks; a band is band_rows input rows, which read at
// most smem_rows output rows.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
upsample2x_bwd_kernel(const T* __restrict__ g, T* __restrict__ gin, int h,
                      int w, int bands, int band_rows, int smem_rows,
                      BwdAxis ya, BwdAxis xa) {
  extern __shared__ __align__(16) float smem[];
  const int w2 = 2 * w;
  float* gx = smem;                  // the band's output rows along W, x w
  T* slab = reinterpret_cast<T*>(smem + slab_offset(smem_rows * w));
  const int64_t plane = blockIdx.x / bands;
  const int band = blockIdx.x - static_cast<int>(plane * bands);
  const int q0 = band * band_rows;
  const int q1 = min(q0 + band_rows, h);
  const int lo = ya.o[q0 * ya.k];
  const int rows = ya.o[(q1 - 1) * ya.k + ya.n[q1 - 1] - 1] - lo + 1;
  stage(slab, g + (plane * 2 * h + lo) * static_cast<int64_t>(w2), rows * w2);
  __syncthreads();

  // A: gather along W for the output rows the band reads
  {
    const Lanes t(w);
    if (t.group < t.groups) {
      for (int ix = t.lane; ix < w; ix += t.lanes) {
        const int n = xa.n[ix];
        int o[kMaxTaps];
        float wt[kMaxTaps];
#pragma unroll
        for (int j = 0; j < kMaxTaps; ++j) {
          o[j] = j < n ? xa.o[ix * xa.k + j] : 0;
          wt[j] = j < n ? xa.w[ix * xa.k + j] : 0.f;
        }
        for (int r = t.group; r < rows; r += t.groups) {
          const T* row = slab + r * w2;
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < kMaxTaps; ++j)
            if (j < n) acc = acc + to_f(row[o[j]]) * wt[j];
          gx[r * w + ix] = acc;
        }
      }
    }
  }
  __syncthreads();

  // B: gather along H, V adjacent inputs of one row per thread; round once
  T* ip = gin + (plane * h + q0) * static_cast<int64_t>(w);
  const int runs = w / V;
  const Lanes t(runs);
  if (t.group >= t.groups) return;
  for (int r = t.group; r < q1 - q0; r += t.groups) {
    const int iy = q0 + r;
    const int n = ya.n[iy];
    for (int c = t.lane; c < runs; c += t.lanes) {
      const int ix = c * V;
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.f;
      for (int k = 0; k < n; ++k) {
        float row[V];
        load_v<V>(gx + (ya.o[iy * ya.k + k] - lo) * w + ix, row);
        const float wk = ya.w[iy * ya.k + k];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = acc[j] + row[j] * wk;
      }
      if (V == 1) {
        store1(ip + static_cast<int64_t>(r) * w + ix, acc[0]);
      } else {
        store16(ip + static_cast<int64_t>(r) * w + ix, acc);
      }
    }
  }
}

int blocks_of(int64_t planes, int bands) {
  const int64_t n = planes * bands;
  return n > 0x7fffffff ? -1 : static_cast<int>(n);
}

// 0, or the error that forbids launching `kernel` on `blocks` blocks with
// `smem` bytes of shared memory (over 48 KiB it has to be allowed first)
template <typename K>
int allow(K kernel, int blocks, int smem) {
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= kSmemDefault) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

// Forward: out (planes, 2h, 2w) from x (planes, h, w), both contiguous, of
// bfloat16 (bf16 != 0) or float32. Tables (device, int32 / float32):
// yidx = (y0, y1) as (2, 2h), ywt = (1 - wy, wy) as (2, 2h); xidx, xwt the
// same for W. band_rows output rows per block, which read at most smem_rows
// input rows; smem_bytes of shared memory (smem_rows x 2w floats, padded to
// 16 bytes, then smem_rows x w elements). On `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int upsample2x_fwd(const void* x, void* out, int bf16,
                              int64_t planes, int h, int w, const int* yidx,
                              const float* ywt, const int* xidx,
                              const float* xwt, int band_rows, int smem_rows,
                              int smem_bytes, void* stream) {
  const FwdAxis ya{yidx, yidx + 2 * h, ywt, ywt + 2 * h};
  const FwdAxis xa{xidx, xidx + 2 * w, xwt, xwt + 2 * w};
  const int bands = (2 * h + band_rows - 1) / band_rows;
  const int blocks = blocks_of(planes, bands);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (2 * w) % (bf16 ? 8 : 4) == 0;
#define UP_FWD(T, V)                                                          \
  do {                                                                        \
    auto k = upsample2x_fwd_kernel<T, V>;                                     \
    const int e = allow(k, blocks, smem_bytes);                           \
    if (e) return e;                                                          \
    k<<<blocks, kThreads, smem_bytes, s>>>(static_cast<const T*>(x),          \
                                           static_cast<T*>(out), h, w, bands, \
                                           band_rows, smem_rows, ya, xa);     \
  } while (0)
  if (bf16) {
    if (vec) UP_FWD(__nv_bfloat16, 8); else UP_FWD(__nv_bfloat16, 1);
  } else {
    if (vec) UP_FWD(float, 4); else UP_FWD(float, 1);
  }
#undef UP_FWD
  return static_cast<int>(cudaGetLastError());
}

// Backward: gin (planes, h, w) from g (planes, 2h, 2w), contiguous, of
// bfloat16 (bf16 != 0) or float32. Inverse tables (device): for each input
// row iy, youts[iy * ky + j] (int32) and ywts[...] (float32) for j <
// ycount[iy]; the same for W with kx. band_rows input rows per block, which
// read at most smem_rows output rows; smem_bytes of shared memory (smem_rows
// x w floats, padded to 16 bytes, then smem_rows x 2w elements). On
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int upsample2x_bwd(const void* g, void* gin, int bf16,
                              int64_t planes, int h, int w, const int* youts,
                              const float* ywts, const int* ycount, int ky,
                              const int* xouts, const float* xwts,
                              const int* xcount, int kx, int band_rows,
                              int smem_rows, int smem_bytes, void* stream) {
  if (ky > kMaxTaps || kx > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdAxis ya{youts, ywts, ycount, ky};
  const BwdAxis xa{xouts, xwts, xcount, kx};
  const int bands = (h + band_rows - 1) / band_rows;
  const int blocks = blocks_of(planes, bands);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = w % (bf16 ? 8 : 4) == 0;
#define UP_BWD(T, V)                                                          \
  do {                                                                        \
    auto k = upsample2x_bwd_kernel<T, V>;                                     \
    const int e = allow(k, blocks, smem_bytes);                           \
    if (e) return e;                                                          \
    k<<<blocks, kThreads, smem_bytes, s>>>(static_cast<const T*>(g),          \
                                           static_cast<T*>(gin), h, w, bands, \
                                           band_rows, smem_rows, ya, xa);     \
  } while (0)
  if (bf16) {
    if (vec) UP_BWD(__nv_bfloat16, 8); else UP_BWD(__nv_bfloat16, 1);
  } else {
    if (vec) UP_BWD(float, 4); else UP_BWD(float, 1);
  }
#undef UP_BWD
  return static_cast<int>(cudaGetLastError());
}
