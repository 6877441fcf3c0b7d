// Tap-grouped modulated bilinear sampling, forward: the DCNv2 sampler.
//
// Replaces minddet_tpu/ops/hat_sample.py:_fwd_taps_kernel (reached through
// _fwd_taps_pallas <- hat_sample_2d_taps <- ops/dcn.py:deform_conv2d).
//
//   out[b, p, k*C + c] = scale[b,k,p] * sum over the 4 corners (cy, cx) of
//                        w(cy, cx) * x[b, cy, cx, c]
//
// with w the bilinear weights of the sample (ys[b,k,p], xs[b,k,p]) and every
// corner outside the image dropped on its own (zero padding). x is NHWC
// (B, H, W, C) in bf16 or f32; ys, xs, scale are tap-major (B, K, P) f32;
// out is (B, P, K*C) in x's type, the layout the DCN weight contraction
// consumes with no relayout.
//
// What bounds it on an H100: memory. It writes B*P*K*C*elt bytes and reads
// x (at most 1 MB per image on the CenterNet path, so L2 holds it across
// the 4*K gathers of each texel) plus 3*B*K*P*4 bytes of coordinates; the
// arithmetic is 4 FMAs per output value. The TPU kernel's hat-weight
// matrices, row windows, spill sweep and tap groups exist for VMEM and the
// MXU; on Hopper the op is a plain gather.
//
// Design: one thread per 16-byte vector of the output (8 bf16 or 4 f32
// channels). Thread t owns vector v = t % (C/VEC) of sample s = t / (C/VEC),
// s = (b*P + p)*K + k, so a warp covers C-wide rows of consecutive (position,
// tap) samples: each corner read is a coalesced C-wide row and the output is
// written as one contiguous stream. Each thread recomputes its sample's four
// corner weights in f32 (the coordinate loads are broadcasts within the
// warp), accumulates in f32 and applies the scale last, as the reference
// does. TMA, larger tiles and fusing the contraction are later work.

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

template <typename V>
__global__ void __launch_bounds__(kThreads)
hat_sample_taps_fwd_kernel(const typename V::T* __restrict__ x,
                           const float* __restrict__ ys,
                           const float* __restrict__ xs,
                           const float* __restrict__ scale,
                           typename V::T* __restrict__ out, int H, int W,
                           int C, int K, int P, uint32_t total) {
  using T = typename V::T;
  constexpr int kVec = V::kVec;
  const uint32_t nv = static_cast<uint32_t>(C / kVec);
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < total) {
    const uint32_t s = t / nv;            // (b*P + p)*K + k
    const uint32_t v = t - s * nv;        // vector within the C-wide row
    const uint32_t k = s % K;
    const uint32_t bp = s / K;
    const uint32_t p = bp % P;
    const uint32_t b = bp / P;
    const size_t ci = (static_cast<size_t>(b) * K + k) * P + p;
    const float y = ys[ci];
    const float xx = xs[ci];
    const float sc = scale[ci];

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
      // bounds are tested in float so far-out coordinates never reach an
      // int conversion
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
}

template <typename V>
void launch(const void* x, const float* ys, const float* xs,
            const float* scale, void* out, int B, int H, int W, int C, int K,
            int P, cudaStream_t stream) {
  const uint32_t total =
      static_cast<uint32_t>(B) * P * K * static_cast<uint32_t>(C / V::kVec);
  if (total == 0) return;
  const uint32_t blocks = (total + kThreads - 1) / kThreads;
  hat_sample_taps_fwd_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const typename V::T*>(x), ys, xs, scale,
      static_cast<typename V::T*>(out), H, W, C, K, P, total);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The caller guarantees contiguous
// tensors, 16-byte aligned x and out, C % 8 == 0 and fewer than 2**31
// output values (so every index fits 32 bits and one thread per output
// vector fits the grid). Returns cudaGetLastError() after the launch.
extern "C" int hat_sample_taps_fwd(const void* x, const float* ys,
                                   const float* xs, const float* scale,
                                   void* out, int B, int H, int W, int C,
                                   int K, int P, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<F32x4>(x, ys, xs, scale, out, B, H, W, C, K, P, st);
  } else if (dtype == 1) {
    launch<Bf16x8>(x, ys, xs, scale, out, B, H, W, C, K, P, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
