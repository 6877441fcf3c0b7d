// Batched weighted row gather ("bilinear gather"), forward.
//
// Replaces minddet_tpu/ops/bilinear.py:49 _fwd_kernel (reached through
// _fwd_pallas <- bilinear_gather <- bilinear_sample_2d <-
// heads/second_stage.py:BEVFeatureExtractor, ops/roi_align.py:roi_align and
// data/transforms.py:warp_images where a gradient is asked of the warp; the
// input warps, which ask none, take csrc/bilinear_warp.cu).
//
//   out[b, p, :] = sum over the 4 corners c of cw[b, p, c] * x[b, ci[b, p, c], :]
//
// x is (B, HW, C) in f32 or bf16, ci (B, P, 4) int32 row indices, cw
// (B, P, 4) f32 weights, out (B, P, C) in x's type. A corner with ci < 0 is
// skipped whatever its weight (bilinear_sample_2d marks corners outside the
// map by ci = -1 and leaves their weights as they are); an index past the
// last row reads the last row, as the reference's clipped gather does.
//
// What bounds it on an H100: memory. It writes B*P*C*elt bytes and reads the
// rows of x that the corners touch (at most 4 per output row) plus 32 bytes
// of indices and weights per output row; the arithmetic is 4 FMAs per output
// value. The TPU kernel builds a (tile, HW) one-hot selection matrix in VMEM
// and multiplies it with the resident map on the MXU, in bf16, because a TPU
// has no fast gather; on Hopper the op is a plain gather.
//
// Design: one thread per 16-byte vector of one output row (4 f32 or 8 bf16
// channels), vectors of a row on neighbouring threads, so each corner read
// is a coalesced C-wide row and the output is one contiguous stream. Each
// thread loads its row's four indices and weights as two 16-byte vectors
// (broadcasts within the row's threads), accumulates the corners in order in
// f32 and rounds once to x's type. Thread indices are 32-bit where the
// output has fewer than 2**31 vectors and 64-bit past that; every offset
// into x and out is 64-bit. The 32-bit divisions by the row width and by P
// are cheaper: 64-bit indices throughout took 8-11 % longer at the R-CNN
// ROIAlign shapes and 1-7 % at CenterPoint's on an H100
// (scripts/time_gather.py --wide, against the 32-bit kernel).

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

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
bilinear_gather_fwd_kernel(const typename V::T* __restrict__ x,
                           const int4* __restrict__ ci,
                           const float4* __restrict__ cw,
                           typename V::T* __restrict__ out, int HW, int C,
                           int P, I total) {
  using T = typename V::T;
  constexpr int kVec = V::kVec;
  const I nv = static_cast<I>(C / kVec);
  const I t = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const I s = t / nv;        // b * P + p
  const I v = t - s * nv;    // vector within the C-wide row
  const I b = s / static_cast<I>(P);
  const int4 i4 = __ldg(ci + s);
  const float4 w4 = __ldg(cw + s);
  const int idx[4] = {i4.x, i4.y, i4.z, i4.w};
  const float wgt[4] = {w4.x, w4.y, w4.z, w4.w};

  const T* xb = x + static_cast<size_t>(b) * HW * C + v * kVec;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (idx[c] >= 0) {
      float row[kVec];
      V::load(xb + static_cast<size_t>(min(idx[c], HW - 1)) * C, row);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(wgt[c], row[i], acc[i]);
    }
  }
  V::store(out + static_cast<size_t>(s) * C + v * kVec, acc);
}

template <typename V>
int launch(const void* x, const void* ci, const void* cw, void* out, int B,
           int HW, int C, int P, int wide, cudaStream_t stream) {
  const uint64_t total = static_cast<uint64_t>(B) * static_cast<uint64_t>(P) *
                         static_cast<uint64_t>(C / V::kVec);
  if (total == 0) return 0;
  const uint64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffu || (!wide && total >= (1ull << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  using T = typename V::T;
  if (wide) {
    bilinear_gather_fwd_kernel<V, uint64_t>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const int4*>(ci),
            static_cast<const float4*>(cw), static_cast<T*>(out), HW, C, P,
            total);
  } else {
    bilinear_gather_fwd_kernel<V, uint32_t>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const int4*>(ci),
            static_cast<const float4*>(cw), static_cast<T*>(out), HW, C, P,
            static_cast<uint32_t>(total));
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. wide: 1 indexes the threads with 64
// bits, 0 with 32 bits, which is faster and refused from 2**31 output
// vectors on. The caller guarantees contiguous tensors, 16-byte
// aligned x, ci, cw and out, C a multiple of 4 (f32) or 8 (bf16) and
// HW >= 1; offsets into x and out are 64-bit. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for what it does not take.
extern "C" int bilinear_gather_fwd(const void* x, const void* ci,
                                   const void* cw, void* out, int B, int HW,
                                   int C, int P, int dtype, int wide,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = launch<F32x4>(x, ci, cw, out, B, HW, C, P, wide, st);
  } else if (dtype == 1) {
    err = launch<Bf16x8>(x, ci, cw, out, B, HW, C, P, wide, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
