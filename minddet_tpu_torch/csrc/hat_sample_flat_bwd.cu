// Flat modulated bilinear sampling, backward: the gradient of the sampler
// in csrc/hat_sample_flat.cu.
//
// Replaces minddet_tpu/ops/hat_sample.py:_bwd_kernel (reached through
// _bwd_pallas <- the custom_vjp of hat_sample_2d <- ops/dcn.py's flat
// branch, DCN layers whose Cin is not a multiple of 128).
//
// For each sample s = (b, n), with corner rows v_ij = x[b, y0+i, x0+j, :]
// (zero out of bounds), bilinear weights w_ij, fy = ys - y0, fx = xs - x0,
// the incoming g[b, n, :] and the dots d_ij = sum_c g * v_ij:
//
//   dscale[b,n] = sum_ij w_ij d_ij
//   dys[b,n]    = scale * ((1-fx)(d10 - d00) + fx (d11 - d01))
//   dxs[b,n]    = scale * ((1-fy)(d01 - d00) + fy (d11 - d10))
//   dx[b, y0+i, x0+j, :] += scale * w_ij * g   (in-bounds corners only)
//
// This is the gradient of the corner gather with floor held fixed, as the
// reference's XLA path differentiates it: at an integer coordinate dys and
// dxs are forward differences. The TPU kernel's hat subgradient
// (_factors(grad=True)) is zero there, which would leave zero-initialised
// offset convs at zero; that is not carried over.
//
// What bounds it on an H100: memory. It reads g once (B*N*C values), the x
// rows the samples touch (a 128x128x64 bf16 map is 2 MB per image, so L2
// holds what neighbouring samples share) and the three (B,N) f32
// coordinate arrays, and writes the three (B,N) f32 gradients and dx. dx is
// accumulated in an f32 scratch image (B,H,W,C), zeroed by the caller: one
// read-modify-write in L2 per non-zero corner contribution, then, for a
// bf16 x, one pass that rounds it to bf16 (for an f32 x the scratch is
// dx). About 16 flops per g value, far below the card's rate.
//
// Design: a group of G lanes of one warp per sample, G the power of two
// >= C/VEC capped at 32 (C = 64 in bf16: 8 vectors, G = 8, four samples per
// warp). Lane j of the group takes the sample's vectors j, j+G, ... (16
// bytes each, 8 bf16 or 4 f32 channels; one channel each when C is not a
// multiple of VEC or a row is not 16-byte aligned, so any C >= 1 is
// taken). Each lane
//  - dots its g values with the four corner rows, in f32;
//  - adds scale*w_ij*g into the scratch with atomicAdd (float4 atomics in
//    global memory on sm_90 for the vector path), skipping zero weights
//    (three of the four corners at an integer coordinate);
// then the group sums its four dots with xor shuffles and its first lane
// forms and writes dys, dxs and dscale. Every lane adds its own vectors in
// one order and the shuffle tree is fixed, so the three coordinate
// gradients repeat bit for bit from run to run; dx does not (its atomics
// land in any order).

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
};

struct F32x1 {
  using T = float;
  static constexpr int kVec = 1;
  static __device__ __forceinline__ void load(const T* p, float* v) { v[0] = __ldg(p); }
};

struct Bf16x1 {
  using T = __nv_bfloat16;
  static constexpr int kVec = 1;
  static __device__ __forceinline__ void load(const T* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <int kVec>
__device__ __forceinline__ void scatter(float* p, float a, const float* g) {
  if constexpr (kVec == 1) {
    atomicAdd(p, a * g[0]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      atomicAdd(reinterpret_cast<float4*>(p + i),
                make_float4(a * g[i], a * g[i + 1], a * g[i + 2],
                            a * g[i + 3]));
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
hat_sample_flat_bwd_kernel(const typename V::T* __restrict__ g,
                           const typename V::T* __restrict__ x,
                           const float* __restrict__ ys,
                           const float* __restrict__ xs,
                           const float* __restrict__ scale,
                           float* __restrict__ acc, float* __restrict__ dys,
                           float* __restrict__ dxs, float* __restrict__ dsc,
                           int H, int W, int C, int N, uint64_t samples,
                           int log2g) {
  constexpr int kVec = V::kVec;
  const int nv = C / kVec;
  const int group = 1 << log2g;
  const uint64_t t = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const uint64_t s = t >> log2g;              // b*N + n
  const int lane = static_cast<int>(t & (group - 1));
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  float sc = 0.f, fy = 0.f, fx = 0.f;
  if (s < samples) {
    const uint64_t b = s / static_cast<uint64_t>(N);
    const float y = ys[s];
    const float xx = xs[s];
    sc = scale[s];
    const float y0 = floorf(y);
    const float x0 = floorf(xx);
    fy = y - y0;
    fx = xx - x0;
    const float cy[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
    const float cx[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
    const float cw[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                         fy * (1.f - fx), fy * fx};
    // the bounds test in float comes first: only an in-bounds corner is
    // converted to an integer offset
    bool inb[4];
    size_t off[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      inb[c] = cy[c] >= 0.f && cy[c] < H && cx[c] >= 0.f && cx[c] < W;
      off[c] = inb[c] ? (b * H * W + static_cast<size_t>(cy[c]) * W +
                         static_cast<size_t>(cx[c])) * C
                      : 0;
    }
    const typename V::T* gs = g + s * C;
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
        if (a != 0.f) scatter<kVec>(acc + off[c] + v * kVec, a, gv);
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
    dsc[s] = w00 * dot[0] + w01 * dot[1] + w10 * dot[2] + w11 * dot[3];
    dys[s] = sc * ((1.f - fx) * (dot[2] - dot[0]) + fx * (dot[3] - dot[1]));
    dxs[s] = sc * ((1.f - fy) * (dot[1] - dot[0]) + fy * (dot[3] - dot[2]));
  }
}

// dx = bf16(acc) over n values, rounded once: 8 per thread where they are
// whole vectors, one per thread for the tail
__global__ void __launch_bounds__(kThreads)
flush_bf16_kernel(const float* __restrict__ acc,
                  __nv_bfloat16* __restrict__ dx, uint64_t n) {
  const uint64_t t = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const uint64_t n8 = n / 8;
  if (t < n8) {
    const float4 lo = reinterpret_cast<const float4*>(acc)[2 * t];
    const float4 hi = reinterpret_cast<const float4*>(acc)[2 * t + 1];
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
    h[0] = __floats2bfloat162_rn(lo.x, lo.y);
    h[1] = __floats2bfloat162_rn(lo.z, lo.w);
    h[2] = __floats2bfloat162_rn(hi.x, hi.y);
    h[3] = __floats2bfloat162_rn(hi.z, hi.w);
    reinterpret_cast<uint4*>(dx)[t] = q;
  } else if (t < n8 + n % 8) {
    const uint64_t i = 8 * n8 + (t - n8);
    dx[i] = __float2bfloat16_rn(acc[i]);
  }
}

template <typename V>
void launch(const void* g, const void* x, const float* ys, const float* xs,
            const float* scale, float* acc, float* dys, float* dxs,
            float* dsc, int B, int H, int W, int C, int N,
            cudaStream_t stream) {
  const int nv = C / V::kVec;
  const uint64_t samples = static_cast<uint64_t>(B) * N;
  if (samples == 0 || nv == 0) return;
  int log2g = 0;
  while ((1 << log2g) < nv && log2g < 5) ++log2g;
  const uint64_t total = samples << log2g;
  const uint64_t blocks = (total + kThreads - 1) / kThreads;
  hat_sample_flat_bwd_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  stream>>>(
      static_cast<const typename V::T*>(g),
      static_cast<const typename V::T*>(x), ys, xs, scale, acc, dys, dxs,
      dsc, H, W, C, N, samples, log2g);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g (B, N, C) and x (B, H, W, C) in that
// type; ys, xs, scale (B, N) f32; acc (B, H, W, C) f32 zeroed by the
// caller; dys, dxs, dsc (B, N) f32, written whole. For float32, dx must be
// acc (the scratch is the result); for bfloat16, dx (B, H, W, C) receives
// acc rounded. vec: 1 when C is a multiple of 4 (f32) or 8 (bf16) and g
// and x are 16-byte aligned, else 0 (one channel per lane step). The caller
// guarantees contiguous tensors and C >= 1. Returns cudaGetLastError()
// after the launches.
extern "C" int hat_sample_flat_bwd(const void* g, const void* x,
                                   const float* ys, const float* xs,
                                   const float* scale, float* acc, void* dx,
                                   float* dys, float* dxs, float* dsc, int B,
                                   int H, int W, int C, int N, int dtype,
                                   int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (dx != static_cast<void*>(acc)) return static_cast<int>(cudaErrorInvalidValue);
    if (vec) launch<F32x4>(g, x, ys, xs, scale, acc, dys, dxs, dsc, B, H, W, C, N, st);
    else launch<F32x1>(g, x, ys, xs, scale, acc, dys, dxs, dsc, B, H, W, C, N, st);
  } else if (dtype == 1) {
    if (vec) launch<Bf16x8>(g, x, ys, xs, scale, acc, dys, dxs, dsc, B, H, W, C, N, st);
    else launch<Bf16x1>(g, x, ys, xs, scale, acc, dys, dxs, dsc, B, H, W, C, N, st);
    const uint64_t n = static_cast<uint64_t>(B) * H * W * C;
    if (n > 0) {
      const uint64_t threads = n / 8 + n % 8;
      flush_bf16_kernel<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                          kThreads, 0, st>>>(
          acc, static_cast<__nv_bfloat16*>(dx), n);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
