// Batched weighted row gather ("bilinear gather"), backward with respect to
// the map: every dx row is the sum of the weighted gradient rows of the
// corners that read it.
//
// Replaces minddet_tpu/ops/bilinear.py:83 _bwd_dx_kernel (reached through
// _bwd_dx_pallas <- _vjp_bwd, the VJP of bilinear_gather <-
// bilinear_sample_2d <- heads/second_stage.py:BEVFeatureExtractor).
//
//   dx[b, q, :] = sum_{p, c : min(ci[b,p,c], HW-1) = q, ci >= 0}
//                     cw[b, p, c] * g[b, p, :]
//
// g is (B, P, C) in f32 or bf16 (the map's type), ci (B, P, 4) int32 row
// indices, cw (B, P, 4) f32 weights, dx (B, HW, C) in g's type. A corner
// with ci < 0 adds nothing whatever its weight, as the forward skips it; an
// index past the last row adds into the last row, as the forward reads it.
// Each row is summed in f32 and rounded once; rows no corner reads are 0.
//
// What bounds it on an H100: memory. dx is the whole map and is written
// once (B*HW*C values), while the corners touch at most 4*P rows of it; g
// (B*P*C values) and 32 bytes of indices and weights per point are read
// once. The arithmetic is 4 multiply-adds per g value.
//
// Design: the TPU kernel's own scheme, each row tile owning its dx rows.
// The 4*B*P corner ids e = (b*P + p)*4 + c (also the flat index of ci and
// cw) are bucketed by destination row tile (TQ rows of one image, T tiles
// per image) in three small passes over the corners, linear in P:
//   count: count[b*T + row/TQ] += 1 for every kept corner (int atomics);
//   scan:  start = exclusive scan of count (one block), count reset to 0;
//   fill:  ids[start[t] + atomicAdd(count[t], 1)] = e.
// The fill's order within a bucket is whatever the atomics give, so the
// tile's block first puts its bucket in one fixed order: it sorts the keys
// (row in the tile, e) in shared memory (bitonic), so that each row's
// corners lie together in ascending e. A bucket larger than the sort's
// capacity CAP (every point on one row) is taken in windows of ascending e,
// each of at most CAP ids, found with a 256-bin histogram of the ids that
// narrows until a window fits. Then one thread per (row, 16-byte vector)
// of the tile walks the row's corners in that order and adds cw * g into
// an f32 tile in shared memory (TQ x C), which it alone writes; after the
// last window every row of the tile is rounded and written once, zeros
// included. A tile with an empty bucket writes zeros at once. There is no
// full-map f32 scratch and no global float atomic, and every dx value is
// the same sum in the same order on every call: dx repeats bit for bit.
// The only scratch is count, start and ids: 4*B*P + 2*B*T + 1 int32. The
// tile's rows TQ and CAP come from the wrapper's plan
// (ops/bilinear.py:gather_bwd_dx_plan), with the shared-memory bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kBins = 256;

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

// the bucket of kept corner e, or -1 for a skipped one (ci < 0)
__device__ __forceinline__ int bucket_of(const int* __restrict__ ci,
                                         uint32_t e, uint32_t p4, int HW,
                                         int TQ, int T) {
  const int q = __ldg(ci + e);
  if (q < 0) return -1;
  return static_cast<int>(e / p4) * T + min(q, HW - 1) / TQ;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ ci, int* __restrict__ count, uint32_t n,
             uint32_t p4, int HW, int TQ, int T) {
  const uint32_t e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int t = bucket_of(ci, e, p4, HW, TQ, T);
  if (t >= 0) atomicAdd(count + t, 1);
}

// start[i] = count[0] + ... + count[i-1] for i <= nt; count reset to 0
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ count, int* __restrict__ start, int nt) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < nt; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < nt ? count[i] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    const int incl = x + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i < nt) {
      start[i] = carry + incl - v;
      count[i] = 0;
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) start[nt] = carry;
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(const int* __restrict__ ci, const int* __restrict__ start,
            int* __restrict__ cursor, int* __restrict__ ids, uint32_t n,
            uint32_t p4, int HW, int TQ, int T) {
  const uint32_t e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int t = bucket_of(ci, e, p4, HW, TQ, T);
  if (t >= 0) ids[start[t] + atomicAdd(cursor + t, 1)] = static_cast<int>(e);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const typename V::T* __restrict__ g, const int* __restrict__ ci,
            const float* __restrict__ cw, const int* __restrict__ start,
            const int* __restrict__ ids, typename V::T* __restrict__ dx,
            int HW, int C, uint32_t p4, int TQ, int T, int cap) {
  constexpr int kVec = V::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // TQ x C, f32
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(acc + TQ * C);  // cap
  int* seg = reinterpret_cast<int*>(keys + cap);            // TQ + 1
  int* hist = seg + TQ + 1;                                 // kBins
  __shared__ int s_int;

  const int t = blockIdx.x;
  const int b = t / T;
  const int q0 = (t - b * T) * TQ;
  const int rows = min(TQ, HW - q0);
  const int nv = C / kVec;
  const int pairs = rows * nv;
  typename V::T* out = dx + (static_cast<size_t>(b) * HW + q0) * C;
  const int first = start[t];
  const int n = start[t + 1] - first;
  const int* bucket = ids + first;

  float zero[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) zero[i] = 0.f;
  if (n == 0) {
    for (int q = threadIdx.x; q < pairs; q += kThreads) V::store(out + q * kVec, zero);
    return;
  }
  for (int q = threadIdx.x; q < pairs; q += kThreads) {
    *reinterpret_cast<float4*>(acc + q * kVec) = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kVec == 8)
      *reinterpret_cast<float4*>(acc + q * kVec + 4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // the bucket's ids lie in [b * 4P, (b + 1) * 4P); lo moves up window by
  // window
  uint32_t lo = static_cast<uint32_t>(b) * p4;
  const uint32_t end = lo + p4;
  int done = 0;
  while (done < n) {
    uint32_t hi = end;
    if (n - done > cap) {
      uint32_t span = end - lo;
      for (;;) {
        const uint32_t w = (span + kBins - 1) / kBins;
        for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0;
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += kThreads) {
          const uint32_t e = static_cast<uint32_t>(bucket[i]);
          if (e >= lo && e - lo < span) atomicAdd(hist + (e - lo) / w, 1);
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          int cum = 0, k = 0;
          while (k < kBins && cum + hist[k] <= cap) cum += hist[k++];
          s_int = k;
        }
        __syncthreads();
        const int k = s_int;
        __syncthreads();
        if (k > 0) {
          hi = lo + static_cast<uint32_t>(
                        min(static_cast<uint64_t>(k) * w,
                            static_cast<uint64_t>(span)));
          break;
        }
        span = w;  // the first bin alone holds more than cap: narrow to it
      }
    }
    // the window's keys (row in the tile, e), then one fixed order
    if (threadIdx.x == 0) s_int = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const uint32_t e = static_cast<uint32_t>(bucket[i]);
      if (e >= lo && e < hi) {
        const int row = min(__ldg(ci + e), HW - 1) - q0;
        keys[atomicAdd(&s_int, 1)] =
            (static_cast<unsigned long long>(row) << 32) | e;
      }
    }
    __syncthreads();
    const int m = s_int;
    int m2 = 1;
    while (m2 < m) m2 <<= 1;
    for (int i = m + threadIdx.x; i < m2; i += kThreads) keys[i] = ~0ull;
    __syncthreads();
    for (int k = 2; k <= m2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < m2; i += kThreads) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const unsigned long long a = keys[i], c = keys[ixj];
            if ((a > c) == ((i & k) == 0)) {
              keys[i] = c;
              keys[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    // seg[r] = the first sorted index whose row is >= r
    for (int r = threadIdx.x; r <= rows; r += kThreads) {
      const unsigned long long want = static_cast<unsigned long long>(r) << 32;
      int l = 0, h = m;
      while (l < h) {
        const int mid = (l + h) >> 1;
        if (keys[mid] < want) l = mid + 1; else h = mid;
      }
      seg[r] = l;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < pairs; q += kThreads) {
      const int r = q / nv;
      const int v = q - r * nv;
      const int j1 = seg[r + 1];
      int j = seg[r];
      if (j == j1) continue;
      float a[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) a[i] = acc[q * kVec + i];
      for (; j < j1; ++j) {
        const uint32_t e = static_cast<uint32_t>(keys[j]);
        const float w = __ldg(cw + e);
        float gv[kVec];
        V::load(g + static_cast<size_t>(e >> 2) * C + v * kVec, gv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) a[i] = fmaf(w, gv[i], a[i]);
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[q * kVec + i] = a[i];
    }
    __syncthreads();
    done += m;
    lo = hi;
  }
  for (int q = threadIdx.x; q < pairs; q += kThreads) V::store(out + q * kVec, acc + q * kVec);
}

template <typename V>
int launch(const void* g, const int* ci, const float* cw, int* scratch,
           void* dx, int B, int HW, int C, int P, int TQ, int cap, int smem,
           cudaStream_t stream) {
  const int T = (HW + TQ - 1) / TQ;
  const int nt = B * T;
  const uint32_t n = 4u * static_cast<uint32_t>(B) * static_cast<uint32_t>(P);
  const uint32_t p4 = 4u * static_cast<uint32_t>(P);
  int* count = scratch;
  int* start = scratch + nt;
  int* ids = start + nt + 1;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * nt, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const unsigned blocks = (n + kThreads - 1) / kThreads;
    count_kernel<<<blocks, kThreads, 0, stream>>>(ci, count, n, p4, HW, TQ, T);
    scan_kernel<<<1, kScanThreads, 0, stream>>>(count, start, nt);
    fill_kernel<<<blocks, kThreads, 0, stream>>>(ci, start, count, ids, n, p4,
                                                 HW, TQ, T);
  } else {
    err = cudaMemsetAsync(start, 0, sizeof(int) * (nt + 1), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(tile_kernel<V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_kernel<V><<<nt, kThreads, smem, stream>>>(
      static_cast<const typename V::T*>(g), ci, cw, start, ids,
      static_cast<typename V::T*>(dx), HW, C, p4, TQ, T, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of g and dx): 0 = float32, 1 = bfloat16. The caller guarantees
// contiguous tensors, 16-byte aligned g and dx, C a multiple of 4 (f32) or
// 8 (bf16), HW >= 1, 4 * B * P < 2**31, scratch of 4*B*P + 2*B*T + 1 int32
// (T = ceil(HW / tile_rows)), cap a power of two, and smem = the
// plan's bytes: tile_rows * C * 4 + cap * 8 + (tile_rows + 1 + 256) * 4.
// dx is written whole. Returns the first CUDA error of the launches.
extern "C" int bilinear_gather_bwd_dx(const void* g, const void* ci,
                                      const void* cw, void* scratch, void* dx,
                                      int B, int HW, int C, int P,
                                      int tile_rows, int cap, int smem,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ci_ = static_cast<const int*>(ci);
  const float* cw_ = static_cast<const float*>(cw);
  int* sc = static_cast<int*>(scratch);
  if (B <= 0 || HW <= 0 || C <= 0) return 0;
  if (dtype == 0) {
    return launch<F32x4>(g, ci_, cw_, sc, dx, B, HW, C, P, tile_rows, cap,
                         smem, st);
  } else if (dtype == 1) {
    return launch<Bf16x8>(g, ci_, cw_, sc, dx, B, HW, C, P, tile_rows, cap,
                          smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
