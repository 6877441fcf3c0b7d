// Flat modulated bilinear sampling, forward: the DCNv2 sampler of layers
// whose Cin is not a multiple of 128.
//
// Replaces minddet_tpu/ops/hat_sample.py:_fwd_kernel (reached through
// _fwd_pallas <- hat_sample_2d <- ops/dcn.py:deform_conv2d, whose flat
// branch hands it the position-major samples (B, Ho*Wo*K)).
//
//   out[b, n, c] = scale[b,n] * sum over the 4 corners (cy, cx) of
//                  w(cy, cx) * x[b, cy, cx, c]
//
// with w the bilinear weights of the sample (ys[b,n], xs[b,n]) from floor,
// and every corner outside the image dropped on its own (zero padding). x
// is NHWC (B, H, W, C) in bf16 or f32, any C >= 1; ys, xs, scale are (B, N)
// f32; out is (B, N, C) in x's type: the f32 sum times the scale, rounded
// once.
//
// What bounds it on an H100: memory. It writes B*N*C*elt bytes and reads x
// (a 128x128x64 bf16 map is 2 MB per image, so L2 holds the rows that
// neighbouring samples share across their 4 gathers) plus 3*B*N*4 bytes of
// coordinates; the arithmetic is 4 FMAs and a multiply per output value.
// The TPU kernel's hat-weight matrices, row windows, 0/1 expander matmuls
// and spill sweep exist for VMEM and the MXU; on Hopper the op is a plain
// gather, so none of them is carried over.
//
// Design: one thread per 16-byte vector of the output (8 bf16 or 4 f32
// channels) when C is a multiple of that and x and out are 16-byte
// aligned; otherwise one thread per output value (C = 3, 12 or 20 in bf16).
// Thread t owns vector v = t % (C/VEC) of sample s = t / (C/VEC), so a warp
// covers C-wide rows of consecutive samples: each corner read is a
// coalesced C-wide row and the output is written as one contiguous stream.
// Each thread recomputes its sample's four corner weights in f32 (the
// coordinate loads are broadcasts within the warp). Indices are 32-bit when
// the thread count fits, else 64-bit; offsets into x and out are always
// 64-bit. A corner is tested against the map in float before any
// float -> int conversion, so coordinates of any magnitude (the reference
// pads with -1e6), infinities and NaN contribute nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct F32x4 {
  using T = float;
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void load(const T* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

struct Bf16x8 {
  using T = __nv_bfloat16;
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void load(const T* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

struct F32x1 {
  using T = float;
  static constexpr int kVec = 1;
  static __device__ __forceinline__ void load(const T* p, float* v) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void store(T* p, const float* v) { *p = v[0]; }
};

struct Bf16x1 {
  using T = __nv_bfloat16;
  static constexpr int kVec = 1;
  static __device__ __forceinline__ void load(const T* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
hat_sample_flat_fwd_kernel(const typename V::T* __restrict__ x,
                           const float* __restrict__ ys,
                           const float* __restrict__ xs,
                           const float* __restrict__ scale,
                           typename V::T* __restrict__ out, int H, int W,
                           int C, int N, I total) {
  using T = typename V::T;
  constexpr int kVec = V::kVec;
  const I nv = static_cast<I>(C / kVec);
  const I t = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const I s = t / nv;            // b*N + n
  const I v = t - s * nv;        // vector within the C-wide row
  const I b = s / static_cast<I>(N);
  const float y = ys[s];
  const float xx = xs[s];
  const float sc = scale[s];

  const float y0 = floorf(y);
  const float x0 = floorf(xx);
  const float dy = y - y0;
  const float dx = xx - x0;
  const float cy[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
  const float cx[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
  const float cw[4] = {(1.f - dy) * (1.f - dx), (1.f - dy) * dx,
                       dy * (1.f - dx), dy * dx};

  const T* xb = x + static_cast<size_t>(b) * H * W * C + v * kVec;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    // the bounds test in float comes first: only an in-bounds corner is
    // converted to an integer index
    if (cy[c] >= 0.f && cy[c] < H && cx[c] >= 0.f && cx[c] < W) {
      float row[kVec];
      V::load(xb + (static_cast<size_t>(cy[c]) * W +
                    static_cast<size_t>(cx[c])) * C, row);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(cw[c], row[i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] *= sc;
  V::store(out + static_cast<size_t>(s) * C + v * kVec, acc);
}

template <typename V>
void launch(const void* x, const float* ys, const float* xs,
            const float* scale, void* out, int B, int H, int W, int C, int N,
            cudaStream_t stream) {
  const uint64_t total = static_cast<uint64_t>(B) * N *
                         static_cast<uint64_t>(C / V::kVec);
  if (total == 0) return;
  const uint64_t blocks = (total + kThreads - 1) / kThreads;
  const auto* xt = static_cast<const typename V::T*>(x);
  auto* ot = static_cast<typename V::T*>(out);
  if (total <= UINT32_MAX - kThreads) {
    hat_sample_flat_fwd_kernel<V, uint32_t>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            xt, ys, xs, scale, ot, H, W, C, N, static_cast<uint32_t>(total));
  } else {
    hat_sample_flat_fwd_kernel<V, uint64_t>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            xt, ys, xs, scale, ot, H, W, C, N, total);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec: 1 when C is a multiple of 4 (f32)
// or 8 (bf16) and x and out are 16-byte aligned, else 0 (one thread per
// value). The caller guarantees contiguous tensors and C >= 1. Returns
// cudaGetLastError() after the launch.
extern "C" int hat_sample_flat_fwd(const void* x, const float* ys,
                                   const float* xs, const float* scale,
                                   void* out, int B, int H, int W, int C,
                                   int N, int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec) launch<F32x4>(x, ys, xs, scale, out, B, H, W, C, N, st);
    else launch<F32x1>(x, ys, xs, scale, out, B, H, W, C, N, st);
  } else if (dtype == 1) {
    if (vec) launch<Bf16x8>(x, ys, xs, scale, out, B, H, W, C, N, st);
    else launch<Bf16x1>(x, ys, xs, scale, out, B, H, W, C, N, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
