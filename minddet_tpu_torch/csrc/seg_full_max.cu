// Bounded segment max of a sorted point stream, broadcast to every row of
// the segment: the stream PFN's "pillar max back onto every point".
//
// Replaces minddet_tpu/ops/seg_pallas.py:108 _fwd_kernel (reached through
// _run_fwd <- seg_full_max_bounded <- readers/pillar_encoder.py:
// PFNLayer.stream of a non-last layer).
//
// x is (B, N, C) in f32 or bf16; first and last are (B, N) bytes (0/1).
// Rows of one segment are contiguous; a segment starts where first is set
// and its kept rows end where last is set, at most `bound` rows after the
// head (the voxelizer's per-pillar point cap). For a row r between a
// segment's head and its last row l (both included)
//
//   out[b, r, :] = max over rows j in [head, l] of x[b, j, :]
//
// and every other row (past its segment's last row, in a segment with no
// last row, on the invalid tail) is 0. Row r finds l as the nearest row at
// or after r, fewer than `bound` rows away, with last set and no segment
// head in (r, l]; the max then walks back from l to the head, over at most
// `bound` rows. Only max and select touch the values, so bf16 stays exact.
// NaNs are not propagated (fmaxf, __hmax2).
//
// What bounds it on an H100: memory. x is read once and out written once
// (2 * B*N*C*elt bytes, 30.7 MB per 120,000 x 32 f32 sample) plus the two
// flag planes; the arithmetic is one max per value read. The TPU kernel's
// VMEM halo windows, 32-bit sublane rotates and shift levels have no
// counterpart here.
//
// Design: one thread per 16-byte vector of one output row (4 f32 or 8 bf16
// channels), vectors of a row on neighbouring threads, rows of a warp
// contiguous. Each thread walks the flag bytes forward to l (the threads of
// a row read the same bytes: a broadcast), then walks back from l taking
// the max of up to `bound` rows of x. A row of x is read by the threads of
// up to `bound` neighbouring rows, which sit in the same or the next blocks,
// so all but the first read of a line are L1 or L2 hits. A tile of rows
// with a `bound`-row halo staged in shared memory is later work. Thread
// indices are 32-bit below 2**31 output vectors and 64-bit from there on
// (the `wide` argument, as the row gather's), so that the divisions by the
// row width and by N stay 32-bit where they can; every offset is 64-bit.
// 64-bit thread indices everywhere cost this kernel 2.3-2.6 % on an H100
// 80GB HBM3 at 700 W (serve f32 (4, 120000, 32) 38.51 against 37.52 us,
// train bf16 (8, 120000, 32) 40.02 against 39.11 us;
// scripts/seg_max_index_width.py, the two widths in turns).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct F32x4 {
  using Vec = float4;
  static __device__ __forceinline__ Vec zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ Vec vmax(Vec a, Vec b) {
    return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                       fmaxf(a.w, b.w));
  }
};

struct Bf16x8 {
  using Vec = uint4;
  static __device__ __forceinline__ Vec zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  static __device__ __forceinline__ Vec vmax(Vec a, Vec b) {
    Vec r;
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
    __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = __hmax2(pa[i], pb[i]);
    return r;
  }
};

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
seg_full_max_kernel(const typename V::Vec* __restrict__ x,
                    const uint8_t* __restrict__ first,
                    const uint8_t* __restrict__ last,
                    typename V::Vec* __restrict__ out, int N, int nv,
                    int bound, I total) {
  using Vec = typename V::Vec;
  const I t = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const I row = t / static_cast<I>(nv);      // b * N + r
  const int v = static_cast<int>(t - row * static_cast<I>(nv));
  const int r = static_cast<int>(row % static_cast<I>(N));
  const size_t base = static_cast<size_t>(row - r);  // b * N
  const uint8_t* f = first + base;
  const uint8_t* l = last + base;

  // the segment's last kept row: the nearest `last` in [r, r + bound) with
  // no segment head in (r, l]
  const int hi = min(r + bound, N);
  int lrow = -1;
  for (int j = r; j < hi; ++j) {
    if (j > r && f[j]) break;
    if (l[j]) {
      lrow = j;
      break;
    }
  }
  Vec m = V::zero();
  if (lrow >= 0) {
    const Vec* xb = x + base * nv + v;
    m = __ldg(xb + static_cast<size_t>(lrow) * nv);
    const int lo = max(lrow - bound + 1, 0);
    for (int j = lrow; j > lo && !f[j]; --j)
      m = V::vmax(m, __ldg(xb + static_cast<size_t>(j - 1) * nv));
  }
  out[t] = m;
}

template <typename V>
int launch(const void* x, const uint8_t* first, const uint8_t* last,
           void* out, int B, int N, int nv, int bound, int wide,
           cudaStream_t stream) {
  const uint64_t total = static_cast<uint64_t>(B) * static_cast<uint64_t>(N) *
                         static_cast<uint64_t>(nv);
  if (total == 0) return 0;
  const uint64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffu || (!wide && total >= (1ull << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  using Vec = typename V::Vec;
  if (wide) {
    seg_full_max_kernel<V, uint64_t>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const Vec*>(x), first, last, static_cast<Vec*>(out),
            N, nv, bound, total);
  } else {
    seg_full_max_kernel<V, uint32_t>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const Vec*>(x), first, last, static_cast<Vec*>(out),
            N, nv, bound, static_cast<uint32_t>(total));
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. wide: 1 indexes the threads with 64
// bits, 0 with 32 bits, refused from 2**31 output vectors on. x and out
// (B, N, C) contiguous and 16-byte aligned, C a multiple of 4 (f32) or 8
// (bf16) (the wrapper pads the channels with zeros to one); first and last
// (B, N) contiguous bytes; bound >= 1; offsets into x, out and the flags
// are 64-bit. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what it does not take.
extern "C" int seg_full_max(const void* x, const void* first,
                            const void* last, void* out, int B, int N, int C,
                            int bound, int dtype, int wide, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(first);
  const uint8_t* l = static_cast<const uint8_t*>(last);
  int err;
  if (dtype == 0) {
    err = launch<F32x4>(x, f, l, out, B, N, C / 4, bound, wide, st);
  } else if (dtype == 1) {
    err = launch<Bf16x8>(x, f, l, out, B, N, C / 8, bound, wide, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
