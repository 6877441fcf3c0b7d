// Batched weighted row gather ("bilinear gather"), backward with respect to
// the corner weights: a dot product of each gradient row with each of the
// four map rows it was gathered from.
//
// Replaces minddet_tpu/ops/bilinear.py:115 _bwd_dcw_kernel (reached through
// _bwd_dcw_pallas <- _vjp_bwd, the VJP of bilinear_gather <-
// bilinear_sample_2d, whose coordinates get their gradient through the
// weights).
//
//   dcw[b, p, c] = sum over channels of g[b, p, :] * x[b, ci[b, p, c], :]
//
// and 0 where ci[b, p, c] < 0. g (B, P, C) and x (B, HW, C) are f32 or bf16
// (one type), ci (B, P, 4) int32, dcw (B, P, 4) f32. An index past the last
// row reads the last row, as the forward does. Products and sums are f32.
//
// What bounds it on an H100: memory. g is read once (B*P*C*elt bytes), the
// rows of x that the corners touch once (at most 4 per point), the indices
// once, and 16 bytes per point are written; the arithmetic is 4
// multiply-adds per g value. The TPU kernel multiplies g with the whole
// transposed map on the MXU (every <g[p], x[q]> pair of a hit chunk) and
// picks the four corners out of the product with a mask; on Hopper the four
// rows are simply read.
//
// Design: one warp per (b, p, corner). The lanes stride over the 16-byte
// vectors of the two C-wide rows (coalesced), multiply-add into one f32
// partial each, and a shuffle tree sums the 32 partials; lane 0 writes. The
// four warps of a point read the same g row (L1 hits). No atomics: the
// result is the same from run to run, and equal to a sequential f32 sum up
// to the order of the additions. Warp indices are 32-bit below 2**31
// corners and 64-bit from there (64-bit ones throughout took 6 % longer in
// bf16 at CenterPoint's train shape on an H100, scripts/time_gather.py
// --wide); offsets into g and x are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
bilinear_gather_bwd_dcw_kernel(const typename V::T* __restrict__ g,
                               const typename V::T* __restrict__ x,
                               const int* __restrict__ ci,
                               float* __restrict__ dcw, int HW, int C, int P,
                               I total) {
  constexpr int kVec = V::kVec;
  // (b * P + p) * 4 + c
  const I w = static_cast<I>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= total) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const I s = w >> 2;  // b * P + p
  const I b = s / static_cast<I>(P);
  const int idx = __ldg(ci + w);
  float dot = 0.f;
  if (idx >= 0) {  // uniform over the warp
    const typename V::T* gr = g + static_cast<size_t>(s) * C;
    const typename V::T* xr =
        x + (static_cast<size_t>(b) * HW + min(idx, HW - 1)) * C;
    for (int v = lane * kVec; v < C; v += 32 * kVec) {
      float gv[kVec], xv[kVec];
      V::load(gr + v, gv);
      V::load(xr + v, xv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = fmaf(gv[i], xv[i], dot);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
  }
  if (lane == 0) dcw[w] = dot;
}

template <typename V>
int launch(const void* g, const void* x, const void* ci, void* dcw, int B,
           int HW, int C, int P, int wide, cudaStream_t stream) {
  const uint64_t total =
      static_cast<uint64_t>(B) * static_cast<uint64_t>(P) * 4u;
  if (total == 0) return 0;
  const uint64_t blocks = (total + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffu || (!wide && total >= (1ull << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  using T = typename V::T;
  if (wide) {
    bilinear_gather_bwd_dcw_kernel<V, uint64_t>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const T*>(g), static_cast<const T*>(x),
            static_cast<const int*>(ci), static_cast<float*>(dcw), HW, C, P,
            total);
  } else {
    bilinear_gather_bwd_dcw_kernel<V, uint32_t>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const T*>(g), static_cast<const T*>(x),
            static_cast<const int*>(ci), static_cast<float*>(dcw), HW, C, P,
            static_cast<uint32_t>(total));
  }
  return 0;
}

}  // namespace

// dtype (of g and x): 0 = float32, 1 = bfloat16. wide: 1 indexes the warps
// with 64 bits, 0 with 32 bits, refused from 2**31 corners (B*P*4) on. The
// caller guarantees contiguous tensors, 16-byte aligned g and x, C a
// multiple of 4 (f32) or 8 (bf16) and HW >= 1; offsets into g and x are
// 64-bit. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what it does not take.
extern "C" int bilinear_gather_bwd_dcw(const void* g, const void* x,
                                       const void* ci, void* dcw, int B,
                                       int HW, int C, int P, int dtype,
                                       int wide, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = launch<F32x4>(g, x, ci, dcw, B, HW, C, P, wide, st);
  } else if (dtype == 1) {
    err = launch<Bf16x8>(g, x, ci, dcw, B, HW, C, P, wide, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
