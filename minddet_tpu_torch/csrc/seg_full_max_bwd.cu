// Backward of the bounded segment max of a sorted point stream
// (seg_full_max.cu): the gradient of "each pillar's max back onto every
// point of the pillar" with respect to the points.
//
// Replaces minddet_tpu/ops/seg_pallas.py:129 _bwd_kernel (reached through
// _run_bwd <- _op_bwd, the VJP of seg_full_max_bounded <-
// readers/pillar_encoder.py: PFNLayer.stream of a non-last layer).
//
// x, m and g are (B, N, C) in f32 or bf16: the forward's input, its output
// (the segment max at every row from a segment's head to its last kept row,
// 0 elsewhere) and the gradient of that output; first and last are (B, N)
// bytes (0/1) as in the forward. For a row r between a segment's head and
// its last kept row l (both included)
//
//   dx[b, r, :] = (x[b, r, :] == m[b, r, :])
//                 * (sum over rows j in [head, l] of g[b, j, :])
//                 / (number of rows j in [head, l] with x[b, j, :] == m)
//
// per channel: the reduce-max convention, a tie shares the gradient evenly.
// Every other row (past its segment's last kept row, in a segment with no
// last row, on the invalid tail) gets 0, and g at such rows is not summed:
// the forward is the constant 0 there. The sums and counts are f32; the
// equality is taken on the values widened to f32, which is exact for bf16
// (m is a copy of one of the x values it is compared with).
//
// What bounds it on an H100: memory. x, m and g are read once and dx written
// once (4 * B*N*C*elt bytes) plus the two flag planes; the arithmetic is an
// add and a compare per value read.
//
// Design: the forward's. One thread per 16-byte vector of one dx row (4 f32
// or 8 bf16 channels), vectors of a row on neighbouring threads. Each thread
// walks the flag bytes forward to l, reads m at its own row, then walks back
// from l to the head (at most `bound` rows) summing g and counting the rows
// equal to m, in that fixed order: every row of a segment computes the same
// sum, bit for bit, and the result does not change from run to run. A row of
// x and g is read by the threads of up to `bound` neighbouring rows, so all
// but the first read of a line are L1 or L2 hits. m is taken from the
// forward (the autograd function saves its output) and not recomputed: that
// costs one more stream of reads and saves a second walk over x.

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
seg_full_max_bwd_kernel(const typename V::T* __restrict__ x,
                        const typename V::T* __restrict__ m,
                        const typename V::T* __restrict__ g,
                        const uint8_t* __restrict__ first,
                        const uint8_t* __restrict__ last,
                        typename V::T* __restrict__ dx, int N, int nv,
                        int bound, long long total) {
  constexpr int kVec = V::kVec;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long row = t / nv;              // b * N + r
  const int v = static_cast<int>(t - row * nv);
  const int r = static_cast<int>(row % N);
  const long long base = row - r;            // b * N
  const uint8_t* f = first + base;
  const uint8_t* l = last + base;
  const long long C = static_cast<long long>(nv) * kVec;

  // the segment's last kept row, found as the forward finds it
  const int hi = min(r + bound, N);
  int lrow = -1;
  for (int j = r; j < hi; ++j) {
    if (j > r && f[j]) break;
    if (l[j]) {
      lrow = j;
      break;
    }
  }
  float out[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) out[i] = 0.f;
  if (lrow >= 0) {
    const long long col = static_cast<long long>(v) * kVec;
    const typename V::T* xb = x + base * C + col;
    const typename V::T* gb = g + base * C + col;
    float mv[kVec], gsum[kVec], cnt[kVec];
    V::load(m + row * C + col, mv);
#pragma unroll
    for (int i = 0; i < kVec; ++i) gsum[i] = cnt[i] = 0.f;
    const int lo = max(lrow - bound + 1, 0);
    for (int j = lrow;; --j) {
      float xv[kVec], gv[kVec];
      V::load(xb + j * C, xv);
      V::load(gb + j * C, gv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        gsum[i] += gv[i];
        cnt[i] += (xv[i] == mv[i]) ? 1.f : 0.f;
      }
      if (j <= lo || f[j]) break;
    }
    float xr[kVec];
    V::load(xb + r * C, xr);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      out[i] = (xr[i] == mv[i]) ? gsum[i] / fmaxf(cnt[i], 1.f) : 0.f;
  }
  V::store(dx + row * C + static_cast<long long>(v) * kVec, out);
}

template <typename V>
void launch(const void* x, const void* m, const void* g, const uint8_t* first,
            const uint8_t* last, void* dx, int B, int N, int nv, int bound,
            cudaStream_t stream) {
  using T = typename V::T;
  const long long total = static_cast<long long>(B) * N * nv;
  if (total == 0) return;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  seg_full_max_bwd_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(m),
      static_cast<const T*>(g), first, last, static_cast<T*>(dx), N, nv,
      bound, total);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, m, g and dx (B, N, C) contiguous and
// 16-byte aligned, C a multiple of 4 (f32) or 8 (bf16); first and last
// (B, N) contiguous bytes; bound >= 1; B*N*C/VEC below 2**31 * 256. Returns
// cudaGetLastError() after the launch.
extern "C" int seg_full_max_bwd(const void* x, const void* m, const void* g,
                                const void* first, const void* last, void* dx,
                                int B, int N, int C, int bound, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(first);
  const uint8_t* l = static_cast<const uint8_t*>(last);
  if (dtype == 0) {
    launch<F32x4>(x, m, g, f, l, dx, B, N, C / 4, bound, st);
  } else if (dtype == 1) {
    launch<Bf16x8>(x, m, g, f, l, dx, B, N, C / 8, bound, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
