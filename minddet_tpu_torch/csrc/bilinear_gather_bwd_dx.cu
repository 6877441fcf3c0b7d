// Batched weighted row gather ("bilinear gather"), backward with respect to
// the map: a scatter-add of the weighted gradient rows.
//
// Replaces minddet_tpu/ops/bilinear.py:83 _bwd_dx_kernel (reached through
// _bwd_dx_pallas <- _vjp_bwd, the VJP of bilinear_gather <-
// bilinear_sample_2d <- heads/second_stage.py:BEVFeatureExtractor).
//
//   acc[b, ci[b, p, c], :] += cw[b, p, c] * g[b, p, :]   for the 4 corners c
//
// g is (B, P, C) in f32 or bf16 (the map's type), ci (B, P, 4) int32 row
// indices, cw (B, P, 4) f32 weights, acc (B, HW, C) f32, zeroed by the
// caller. A corner with ci < 0 is skipped whatever its weight, as the
// forward skips it; an index past the last row adds into the last row, as
// the forward reads it. For an f32 map acc is dx itself; for a bf16 map the
// caller rounds acc to bf16 once, after all the sums.
//
// What bounds it on an H100: memory, and not the rows it touches: dx is the
// whole map, zero-filled and written (B*HW*C values), while the sample
// points touch at most 4 * P rows of it. g (B*P*C*elt bytes) and 32 bytes of
// indices and weights per point are read once. The arithmetic is 4
// multiply-adds per g value. The TPU kernel builds a (TQ, TP) transposed
// one-hot selection matrix per tile pair and multiplies it with g on the
// MXU, in bf16, skipping tile pairs by a hit bitmap; on Hopper the op is a
// plain scatter with atomics.
//
// Design: one thread per 16-byte vector of one g row (4 f32 or 8 bf16
// channels), vectors of a row on neighbouring threads. A thread loads its g
// vector once, loads its point's four indices and weights as two 16-byte
// vectors (broadcasts within the row's threads), and for each corner issues
// one f32 atomicAdd per channel (red.global.add.f32) into the corner's row,
// neighbouring threads on neighbouring addresses. The five sample points of
// a box and neighbouring boxes hit the same rows, so the order of the
// additions, and with it the last bits of an f32 sum, changes from run to
// run.

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

template <typename V>
__global__ void __launch_bounds__(kThreads)
bilinear_gather_bwd_dx_kernel(const typename V::T* __restrict__ g,
                              const int4* __restrict__ ci,
                              const float4* __restrict__ cw,
                              float* __restrict__ acc, int HW, int C, int P,
                              uint32_t total) {
  constexpr int kVec = V::kVec;
  const uint32_t nv = static_cast<uint32_t>(C / kVec);
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const uint32_t s = t / nv;        // b * P + p
  const uint32_t v = t - s * nv;    // vector within the C-wide row
  const uint32_t b = s / P;
  const int4 i4 = __ldg(ci + s);
  const float4 w4 = __ldg(cw + s);
  const int idx[4] = {i4.x, i4.y, i4.z, i4.w};
  const float wgt[4] = {w4.x, w4.y, w4.z, w4.w};

  float gv[kVec];
  V::load(g + static_cast<size_t>(s) * C + v * kVec, gv);
  float* ab = acc + static_cast<size_t>(b) * HW * C + v * kVec;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (idx[c] >= 0) {
      float* row = ab + static_cast<size_t>(min(idx[c], HW - 1)) * C;
#pragma unroll
      for (int i = 0; i < kVec; ++i) atomicAdd(row + i, wgt[c] * gv[i]);
    }
  }
}

template <typename V>
void launch(const void* g, const void* ci, const void* cw, void* acc, int B,
            int HW, int C, int P, cudaStream_t stream) {
  const uint32_t total =
      static_cast<uint32_t>(B) * P * static_cast<uint32_t>(C / V::kVec);
  if (total == 0) return;
  const uint32_t blocks = (total + kThreads - 1) / kThreads;
  bilinear_gather_bwd_dx_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const typename V::T*>(g), static_cast<const int4*>(ci),
      static_cast<const float4*>(cw), static_cast<float*>(acc), HW, C, P,
      total);
}

}  // namespace

// dtype (of g): 0 = float32, 1 = bfloat16. The caller guarantees contiguous
// tensors, 16-byte aligned g, ci, cw and acc, acc (B, HW, C) f32 and zeroed
// on the same stream, C a multiple of 4 (f32) or 8 (bf16), HW >= 1 and
// fewer than 2**31 values in g and in acc. Returns cudaGetLastError() after
// the launch.
extern "C" int bilinear_gather_bwd_dx(const void* g, const void* ci,
                                      const void* cw, void* acc, int B,
                                      int HW, int C, int P, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<F32x4>(g, ci, cw, acc, B, HW, C, P, st);
  } else if (dtype == 1) {
    launch<Bf16x8>(g, ci, cw, acc, B, HW, C, P, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
