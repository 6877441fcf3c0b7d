// Tap-grouped modulated bilinear sampling, backward: the gradient of the
// DCNv2 sampler in csrc/hat_sample_taps.cu.
//
// Replaces minddet_tpu/ops/hat_sample.py:_bwd_taps_kernel (reached through
// _bwd_taps_pallas <- the custom_vjp of hat_sample_2d_taps <- ops/dcn.py).
//
// For each sample s = (b, p, k), with corner rows v_ij = x[b, y0+i, x0+j, :]
// (zero out of bounds), bilinear weights w_ij, fy = ys - y0, fx = xs - x0,
// and the incoming g[b, p, k*C:(k+1)*C], summing over the C channels:
//
//   dscale[b,k,p] = sum g * sum_ij w_ij v_ij
//   dys[b,k,p]    = scale * sum g * ((1-fx)(v10 - v00) + fx (v11 - v01))
//   dxs[b,k,p]    = scale * sum g * ((1-fy)(v01 - v00) + fy (v11 - v10))
//   dx[b, y0+i, x0+j, :] += scale * w_ij * g      (in-bounds corners only)
//
// This is the gradient of the corner gather with floor held fixed, as the
// reference's XLA path differentiates it: at an integer coordinate dys and
// dxs are forward differences. The TPU kernel's hat subgradient is zero
// there; that is not carried over.
//
// What bounds it on an H100: memory. It reads g once (B*P*K*C values), the
// x rows the samples touch (at most 1 MB of x per image on the CenterNet
// path, so L2 holds it across the 4*K reads of each texel) and the three
// (B,K,P) f32 coordinate arrays, and writes the three (B,K,P) f32 outputs.
// dx is accumulated in an f32 scratch image (B,H,W,C), zeroed by the
// caller: one read-modify-write in L2 per non-zero corner contribution,
// then, for a bf16 x, one pass that flushes it to bf16 (for an f32 x the
// scratch is dx). About 16 flops per g value, far below the memory rate.
//
// Design: a group of G lanes of one warp per sample s = (b*P + p)*K + k, G
// the power of two >= C/VEC capped at 32 (C = 128 in bf16: 16 vectors,
// G = 16, two samples per warp; C = 384: 48 vectors, G = 32, lanes 0-15
// take two). Lane j of the group takes the sample's vectors j, j+G, ...
// (16 bytes each, 8 bf16 or 4 f32 channels), so g is read as one contiguous
// stream and each corner row is a coalesced C-wide read. Each lane
//  - dots its g vectors with the four corner vectors, in f32;
//  - adds scale*w_ij*g into the scratch with float4 atomicAdd (a vector
//    atomic in global memory, sm_90), skipping zero weights (three of the
//    four corners at an integer coordinate);
// then the group sums its four dots with xor shuffles and its first lane
// forms and writes dys, dxs and dscale. This takes any C % 8 == 0 (the
// earlier one-thread-per-vector form needed C/VEC to be a power of two or
// a multiple of 32). Every lane adds its own vectors in one order and the
// shuffle tree is fixed, so the three coordinate gradients repeat bit for
// bit from run to run; dx does not (its atomics land in any order).

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
hat_sample_taps_bwd_kernel(const typename V::T* __restrict__ g,
                           const typename V::T* __restrict__ x,
                           const float* __restrict__ ys,
                           const float* __restrict__ xs,
                           const float* __restrict__ scale,
                           float* __restrict__ acc, float* __restrict__ dys,
                           float* __restrict__ dxs, float* __restrict__ dsc,
                           int H, int W, int C, int K, int P,
                           uint32_t samples, int log2g) {
  constexpr int kVec = V::kVec;
  const int nv = C / kVec;
  const int group = 1 << log2g;
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t s = t >> log2g;          // (b*P + p)*K + k
  const int lane = static_cast<int>(t & (group - 1));
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  float sc = 0.f, fy = 0.f, fx = 0.f;
  size_t ci = 0;
  if (s < samples) {
    const uint32_t k = s % K;
    const uint32_t bp = s / K;
    const uint32_t p = bp % P;
    const uint32_t b = bp / P;
    ci = (static_cast<size_t>(b) * K + k) * P + p;
    const float y = ys[ci];
    const float xx = xs[ci];
    sc = scale[ci];

    const float y0 = floorf(y);
    const float x0 = floorf(xx);
    fy = y - y0;
    fx = xx - x0;
    const float cy[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
    const float cx[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
    const float cw[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                         fy * (1.f - fx), fy * fx};
    // bounds are tested in float so far-out coordinates never reach an
    // int conversion
    bool inb[4];
    size_t off[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      inb[c] = cy[c] >= 0.f && cy[c] < H && cx[c] >= 0.f && cx[c] < W;
      off[c] = inb[c] ? (static_cast<size_t>(b) * H * W +
                         static_cast<size_t>(cy[c]) * W +
                         static_cast<size_t>(cx[c])) * C
                      : 0;
    }
    const typename V::T* gs = g + static_cast<size_t>(s) * C;
    for (int v = lane; v < nv; v += group) {
      float gv[kVec];
      V::load(gs + v * kVec, gv);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!inb[c]) continue;
        float row[kVec];
        V::load(x + off[c] + v * kVec, row);
#pragma unroll
        for (int i = 0; i < kVec; ++i) dot[c] = fmaf(gv[i], row[i], dot[c]);
        const float a = sc * cw[c];
        if (a != 0.f) {
#pragma unroll
          for (int i = 0; i < kVec; i += 4) {
            atomicAdd(reinterpret_cast<float4*>(acc + off[c] + v * kVec + i),
                      make_float4(a * gv[i], a * gv[i + 1], a * gv[i + 2],
                                  a * gv[i + 3]));
          }
        }
      }
    }
  }
  // the group's lanes are aligned in the warp; every lane of the warp takes
  // part in each shuffle
  for (int o = group >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dot[c] += __shfl_xor_sync(0xffffffffu, dot[c], o);
  }
  if (s < samples && lane == 0) {
    const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
    const float w10 = fy * (1.f - fx), w11 = fy * fx;
    dsc[ci] = w00 * dot[0] + w01 * dot[1] + w10 * dot[2] + w11 * dot[3];
    dys[ci] = sc * ((1.f - fx) * (dot[2] - dot[0]) + fx * (dot[3] - dot[1]));
    dxs[ci] = sc * ((1.f - fy) * (dot[1] - dot[0]) + fy * (dot[3] - dot[2]));
  }
}

// dx = bf16(acc), 8 values per thread, rounded once
__global__ void __launch_bounds__(kThreads)
flush_bf16_kernel(const float* __restrict__ acc,
                  __nv_bfloat16* __restrict__ dx, uint32_t n8) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n8) {
    const float4 lo = reinterpret_cast<const float4*>(acc)[2 * t];
    const float4 hi = reinterpret_cast<const float4*>(acc)[2 * t + 1];
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    Bf16x8::store(dx + 8 * static_cast<size_t>(t), v);
  }
}

template <typename V>
void launch(const void* g, const void* x, const float* ys, const float* xs,
            const float* scale, float* acc, float* dys, float* dxs,
            float* dsc, int B, int H, int W, int C, int K, int P,
            cudaStream_t stream) {
  const int nv = C / V::kVec;
  const uint32_t samples = static_cast<uint32_t>(B) * P * K;
  if (samples == 0 || nv == 0) return;
  int log2g = 0;
  while ((1 << log2g) < nv && log2g < 5) ++log2g;
  const uint64_t total = static_cast<uint64_t>(samples) << log2g;
  const uint64_t blocks = (total + kThreads - 1) / kThreads;
  hat_sample_taps_bwd_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  stream>>>(
      static_cast<const typename V::T*>(g),
      static_cast<const typename V::T*>(x), ys, xs, scale, acc, dys, dxs,
      dsc, H, W, C, K, P, samples, log2g);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g (B, P, K*C) and x (B, H, W, C) in
// that type; ys, xs, scale (B, K, P) f32; acc (B, H, W, C) f32, zeroed by
// the caller; dys, dxs, dsc (B, K, P) f32, written whole. For float32, dx
// must be acc (the scratch is the result); for bfloat16 dx (B, H, W, C)
// receives acc rounded. The caller guarantees contiguous tensors, 16-byte
// aligned rows, C % 8 == 0 and fewer than 2**31 values in g and in x.
// Returns cudaGetLastError() after the launches.
extern "C" int hat_sample_taps_bwd(const void* g, const void* x,
                                   const float* ys, const float* xs,
                                   const float* scale, float* acc, void* dx,
                                   float* dys, float* dxs, float* dsc, int B,
                                   int H, int W, int C, int K, int P,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (dx != static_cast<void*>(acc)) return static_cast<int>(cudaErrorInvalidValue);
    launch<F32x4>(g, x, ys, xs, scale, acc, dys, dxs, dsc, B, H, W, C, K, P,
                  st);
  } else if (dtype == 1) {
    launch<Bf16x8>(g, x, ys, xs, scale, acc, dys, dxs, dsc, B, H, W, C, K,
                   P, st);
    const uint32_t n8 = static_cast<uint32_t>(B) * H * W * (C / 8);
    if (n8 > 0) {
      flush_bf16_kernel<<<(n8 + kThreads - 1) / kThreads, kThreads, 0, st>>>(
          acc, static_cast<__nv_bfloat16*>(dx), n8);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
