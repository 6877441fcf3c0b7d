// Modulated bilinear sampling, forward: the DCNv2 samplers, tap-grouped
// and flat. One kernel serves both.
//
// Replaces minddet_tpu/ops/hat_sample.py:_fwd_taps_kernel (K1f, :312,
// reached through _fwd_taps_pallas :606 <- hat_sample_2d_taps <-
// ops/dcn.py:deform_conv2d) through hat_sample_taps_fwd, and
// hat_sample.py:_fwd_kernel (K2f, :171, reached through _fwd_pallas :491 <-
// hat_sample_2d <- ops/dcn.py's flat branch, DCN layers whose Cin is not a
// multiple of 128) through hat_sample_flat_fwd.
//
//   out[b, p, k*C + c] = scale[b,k,p] * sum over the 4 corners (cy, cx) of
//                        w(cy, cx) * x[b, cy, cx, c]
//
// with w the bilinear weights of the sample (ys[b,k,p], xs[b,k,p]) from
// floor, and every corner outside the image dropped on its own (zero
// padding). x is NHWC (B, H, W, C) in bf16 or f32; ys, xs, scale are
// tap-major (B, K, P) f32; out is (B, P, K*C) in x's type, the layout the
// DCN weight contraction consumes with no relayout. The flat samples (B, N)
// are position-major and the flat out (B, N, C) has the memory of a
// tap-grouped (B, P, K*C): the flat sampler is this one with one tap, K = 1
// and P = N.
//
// Arithmetic, value for value that of the one-thread-per-vector kernels it
// replaced: the weights (1-dy)(1-dx), (1-dy)dx, dy(1-dx), dy dx in f32, one
// fmaf per corner in the order 00, 01, 10, 11 from 0, then times the scale
// and one rounding to x's type. A corner off the map is tested in float
// before any integer conversion (+-1e6, +-3e9, +-inf and NaN contribute
// nothing) and adds fmaf(-0, 0, acc) == acc, never x's value, so the output
// is bit-equal to those kernels on every input.
//
// What bounds it on an H100: memory. It writes B*P*K*C*elt bytes and reads
// x's rows the samples touch once plus 3*B*K*P*4 bytes of coordinates; 4
// FMAs and a multiply per output value. The one-thread-per-vector kernel it
// replaced ran at ~2.3x that bound, held neither by its stores (a kernel
// writing the same bytes and gathering nothing runs at 1.07x the output's
// byte time) nor by its gathers through L2 (with every corner in two map
// rows it was no faster), but by the chain each thread ran for its one
// 16-byte vector: three integer divides, three coordinate loads, then four
// corner loads that wait on them, and ~190 instructions a vector.
//
// Design: persistent blocks, two an SM, each walking a run of consecutive
// tiles; a tile is TP consecutive positions of one image with all K taps
// and all C channels, so its output is one contiguous run of TP*K*C values.
// - Pass 1 reads the tile's coordinates coalesced (K runs of TP, several
//   samples a thread in flight; prefetched into L2 while the tile before
//   was swept) and keeps each sample's four weights (-0 for a corner off
//   the map), floor(y), floor(x) and scale in shared memory, in output
//   order s = i*K + k.
// - The window: R whole map rows, chosen per tile from its own samples by
//   K1b's rule (csrc/hat_sample_taps_bwd.cu): a reduction of floor(ys) over
//   the samples that can touch the map (in each warp, then one shared
//   atomic a warp), the rows [min, min+R) where they cover them, else R
//   rows centred on the mean, clamped into the map. The rows live in a ring
//   (row y in slot y % R) kept from tile to tile, so a tile loads only the
//   rows its window adds, about one a map row of positions: one contiguous
//   run of x, loaded with at most two 1-D TMA bulk copies (cp.async.bulk,
//   completion on an mbarrier) where it is 16-byte aligned, else copied by
//   all threads.
// - Pass 1b turns each corner into a byte offset: into the ring, to a
//   zeroed texel after it (a corner off the map), or to x in global memory
//   (on the map outside the window: the fallback, prefetched into L1 here
//   and counted in the optional stats). Without a window (R = 0) pass 1
//   writes the offsets itself, every corner on the map a fallback.
// - The sweep: a unit is kPer 16-byte vectors of one sample (8 bf16 or 4
//   f32 channels; one channel, F32x1 or Bf16x1, where C is not a whole
//   number of vectors or the rows are not aligned, so the flat entry takes
//   any C >= 1); a thread takes kUnroll units at a time, every corner load
//   issued before the FMAs, ~100 instructions a vector. kPer and kUnroll
//   depend on the window and the width (taps_fwd_kernel's note).
// TP, R and the grid come from the wrapper's plan (ops/hat_sample.py:
// taps_fwd_plan, flat_fwd_plan): ring and slots within ~110 KB so that two
// blocks share an SM, each block the same number of tiles give or take one;
// R = 0 where not one row fits and for a call too small to give a block two
// tiles. Offsets into x, out and the coordinates are 64-bit: a launch may
// hold more than 2**31 values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kP1 = 4;  // samples in flight per thread in pass 1
constexpr int kSlotBytes = 36;  // per sample: float4 weights, int4 offsets, scale

struct F32x4 {
  using T = float;
  using Raw = float4;  // one 16-byte vector as loaded
  static constexpr int kVec = 4;
  static __device__ __forceinline__ Raw ldg(const T* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ Raw lds(const T* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

struct Bf16x8 {
  using T = __nv_bfloat16;
  using Raw = uint4;
  static constexpr int kVec = 8;
  static __device__ __forceinline__ Raw ldg(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw lds(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  // a bf16 is the top half of the f32 of the same value: one shift or one
  // mask a value
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
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

// one channel per lane step: any C, any alignment
struct F32x1 {
  using T = float;
  using Raw = float;
  static constexpr int kVec = 1;
  static __device__ __forceinline__ Raw ldg(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ Raw lds(const T* p) { return *p; }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) { v[0] = q; }
  static __device__ __forceinline__ void store(T* p, const float* v) { *p = v[0]; }
};

struct Bf16x1 {
  using T = __nv_bfloat16;
  using Raw = unsigned short;
  static constexpr int kVec = 1;
  static __device__ __forceinline__ Raw ldg(const T* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ Raw lds(const T* p) {
    return *reinterpret_cast<const unsigned short*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    v[0] = __bfloat162float(__ushort_as_bfloat16(q));
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// the marker of a corner off the map in a slot's weights: -0.0f, which no
// weight of a corner on the map takes (each is a product of two values in
// [0, 1] with a +0 at most)
constexpr unsigned kOffMap = 0x80000000u;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The mbarrier bar, for one arrival; one thread calls it before the block
// synchronises.
__device__ __forceinline__ void bulk_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arms bar for `bytes` more bytes to arrive, with this thread's arrival.
__device__ __forceinline__ void bulk_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// The TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global src into shared dst, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// Waits until bar completes the phase of parity `phase`.
__device__ __forceinline__ void bulk_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(b), "r"(phase) : "memory");
  }
}

// A sample's four corner byte offsets: into the ring (row y in slot (y -
// r0 + s0) mod R, s0 = r0 mod R) for a corner in the window [r0, r0 + R),
// the zeroed texel for a corner off the map (its weight is -0), or ~texel
// (< 0) for one on the map outside the window (the fallback, read from
// global memory by the sweep; with a window it is prefetched into L1
// here, so that the sweep's iteration does not wait a round trip to L2 for
// it; without one, where every corner is a fallback, that was slower).
// (iy, ix) = (floor(y), floor(x)); xb is the image's map. Counts the
// corners on the map and the fallbacks.
template <typename T>
__device__ __forceinline__ int4 corner_offsets(const float4& w4, int iy, int ix,
                                               int r0, int R, int s0, int W,
                                               int texel_bytes, int zero,
                                               const T* xb,
                                               unsigned long long& onmap,
                                               unsigned long long& fallback) {
  const float cw[4] = {w4.x, w4.y, w4.z, w4.w};
  int o[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cy = iy + (c >> 1);
    const int cx = ix + (c & 1);
    if (__float_as_uint(cw[c]) == kOffMap) {
      o[c] = zero;
      continue;
    }
    ++onmap;
    if (cy >= r0 && cy < r0 + R) {
      const int slot = cy - r0 < R - s0 ? cy - r0 + s0 : cy - r0 + s0 - R;
      o[c] = (slot * W + cx) * texel_bytes;
    } else {
      o[c] = ~(cy * W + cx);
      ++fallback;
      if (R > 0) {
        const char* row = reinterpret_cast<const char*>(xb) +
                          static_cast<size_t>(~o[c]) * texel_bytes;
        for (int l = 0; l < texel_bytes; l += 128) prefetch_l1(row + l);
      }
    }
  }
  return make_int4(o[0], o[1], o[2], o[3]);
}

// A block walks the run of tiles [blockIdx.x * T / G, (blockIdx.x + 1) * T
// / G) of the T = B * tiles tiles (G blocks); tile t is positions [t' * TP,
// t' * TP + TP) of image t / tiles, t' = t % tiles, with all K taps (tile
// samples s = i * K + k in out's order) and all C channels. Dynamic shared
// memory: the ring of R map rows (row y in slot y % R) and one zeroed
// texel of C values (16-byte aligned), then the slots: TP*K float4
// weights, TP*K int4 corner offsets, TP*K f32 scales.
//
// kPer output vectors of one sample a unit (a power of 2), kUnroll units in
// flight a thread: 4 and 1 with a window, where four vectors a unit halve
// the slot reads and rotating the pieces keeps the ring's banks apart, and
// without one where a sample has at least 16 vectors; 2 and 2 without a
// window for narrower samples (the flat stage-1 sampler, 8 bf16 vectors),
// where every corner waits on L2 and more units a thread keep more loads
// in flight. (Measured on the H100 without a window, bf16: 4 and 1 is 1-8 %
// faster on the tap-grouped DCN maps, 2 and 2 11 % faster on the flat one.)
template <typename V, int kPer, int kUnroll>
__global__ void __launch_bounds__(kThreads, 2)
taps_fwd_kernel(const typename V::T* __restrict__ x,
                const float* __restrict__ ys, const float* __restrict__ xs,
                const float* __restrict__ scale, typename V::T* __restrict__ out,
                unsigned long long* __restrict__ stats, int H, int W, int C,
                int K, int P, int TP, int R, int tiles, long long T) {
  using Tv = typename V::T;
  using Raw = typename V::Raw;
  constexpr int kVec = V::kVec;
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ uint64_t s_bar;
  // the window's row statistics, one set for each parity of the tile
  __shared__ int s_min[2], s_max[2], s_count[2];
  __shared__ unsigned long long s_sum[2], s_fallback, s_onmap;

  const int nv = C / kVec;
  const int RW = R * W;  // texels of the ring
  const int texel_bytes = C * static_cast<int>(sizeof(Tv));
  const int zero = RW * texel_bytes;  // the zeroed texel's byte offset
  Tv* ring = reinterpret_cast<Tv*>(sm);
  float4* wts = reinterpret_cast<float4*>(
      sm + align16(static_cast<size_t>(RW + 1) * C * sizeof(Tv)));
  int4* offs = reinterpret_cast<int4*>(wts + TP * K);
  float* scl = reinterpret_cast<float*>(offs + TP * K);
  const size_t row_vals = static_cast<size_t>(W) * C;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      s_min[i] = H;
      s_max[i] = -2;
      s_count[i] = 0;
      s_sum[i] = 0;
    }
    s_fallback = 0;
    s_onmap = 0;
    bulk_init(&s_bar);
  }
  for (int i = threadIdx.x; i < C; i += kThreads) ring[RW * C + i] = Tv(0.f);
  __syncthreads();

  unsigned long long fallback = 0, onmap = 0;
  int res_b = -1, res_r0 = 0;  // the image and first row the ring holds
  uint32_t phase = 0;  // of s_bar's next completion
  const long long t_end = (blockIdx.x + 1) * T / gridDim.x;
  for (long long t = blockIdx.x * T / gridDim.x; t < t_end; ++t) {
    const int b = static_cast<int>(t / tiles);
    const int p0 = static_cast<int>(t - static_cast<long long>(b) * tiles) * TP;
    const int np = min(TP, P - p0);
    const int n = np * K;  // samples of the tile
    const size_t cbase = static_cast<size_t>(b) * K * P + p0;
    const Tv* xb = x + static_cast<size_t>(b) * H * row_vals;

    // pass 1: the tile's coordinates, coalesced (tap-major: sample j = k *
    // np + i is position i of tap k), kP1 samples a thread in flight; each
    // sample's weights (-0 for a corner off the map), floor(y), floor(x)
    // and scale into its slot; the window's row statistics over the samples
    // that can touch the map, floor(ys) in [-1, H-1], floor(xs) in [-1, W-1]
    {
      int lmin = H, lmax = -2, lcount = 0;
      unsigned long long lsum = 0;
      for (int j0 = threadIdx.x; j0 < n; j0 += kP1 * kThreads) {
        float y[kP1], xx[kP1], sc[kP1];
        int slot[kP1];
#pragma unroll
        for (int u = 0; u < kP1; ++u) {
          const int j = j0 + u * kThreads;
          slot[u] = -1;
          if (j < n) {
            const int k = j / np;
            const int i = j - k * np;
            const size_t ci = cbase + static_cast<size_t>(k) * P + i;
            y[u] = ys[ci];
            xx[u] = xs[ci];
            sc[u] = scale[ci];
            slot[u] = i * K + k;
          }
        }
#pragma unroll
        for (int u = 0; u < kP1; ++u) {
          if (slot[u] < 0) continue;
          const float y0 = floorf(y[u]);
          const float x0 = floorf(xx[u]);
          const float dy = y[u] - y0;
          const float dx = xx[u] - x0;
          const float cy[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
          const float cx[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
          float cw[4] = {(1.f - dy) * (1.f - dx), (1.f - dy) * dx,
                         dy * (1.f - dx), dy * dx};
          bool any = false;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (cy[c] >= 0.f && cy[c] < H && cx[c] >= 0.f && cx[c] < W) {
              any = true;
            } else {
              cw[c] = __uint_as_float(kOffMap);
            }
          }
          int iy = 0, ix = 0;
          if (any) {  // then y0 in [-1, H-1] and x0 in [-1, W-1]
            iy = static_cast<int>(y0);
            ix = static_cast<int>(x0);
            lmin = min(lmin, iy);
            lmax = max(lmax, iy);
            lsum += static_cast<unsigned long long>(iy + 1);
            ++lcount;
          }
          const float4 w4 = make_float4(cw[0], cw[1], cw[2], cw[3]);
          wts[slot[u]] = w4;
          // without a window the offsets need no r0: pass 1b is skipped
          offs[slot[u]] = R == 0 ? corner_offsets(w4, iy, ix, 0, 0, 0, W,
                                                  texel_bytes, zero, xb, onmap,
                                                  fallback)
                                 : make_int4(iy, ix, 0, 0);
          scl[slot[u]] = sc[u];
        }
      }
      if (R > 0 && R < H) {
        // one shared atomic a warp: 256 on one address serialise
        lmin = __reduce_min_sync(0xffffffffu, lmin);
        lmax = __reduce_max_sync(0xffffffffu, lmax);
        lcount = __reduce_add_sync(0xffffffffu, lcount);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
        if ((threadIdx.x & 31) == 0 && lcount > 0) {
          atomicMin(&s_min[t & 1], lmin);
          atomicMax(&s_max[t & 1], lmax);
          atomicAdd(&s_sum[t & 1], lsum);
          atomicAdd(&s_count[t & 1], lcount);
        }
      }
    }
    __syncthreads();

    // with a window: its first row, by K1b's rule, in every thread (then
    // the other parity's statistics are reset for the next tile: every
    // thread read them in the tile before), the rows the ring lacks, and
    // pass 1b
    bool bulk = false;
    if (R > 0) {
      const int q = t & 1;
      int r0 = 0;
      if (R < H && s_count[q] > 0) {
        const int lo = max(s_min[q], 0);
        const int hi = min(s_max[q] + 1, H - 1);
        if (hi - lo + 1 <= R) {
          r0 = lo;
        } else {
          // the mean corner row is the mean floor(ys) + 1/2 (in f32: it
          // places the window, the values do not depend on it)
          const int mean = static_cast<int>(floorf(
              __fdividef(static_cast<float>(s_sum[q]), s_count[q]) + 0.5f)) - 1;
          r0 = mean - (R - 2) / 2;
        }
        r0 = max(0, min(r0, H - R));
      }
      if (threadIdx.x == 0) {
        s_min[q ^ 1] = H;
        s_max[q ^ 1] = -2;
        s_count[q ^ 1] = 0;
        s_sum[q ^ 1] = 0;
      }

      // the window's rows the ring does not hold yet: one contiguous run
      // (both windows are R rows), loaded into slots y % R with at most two
      // bulk copies (the run wraps around the ring at most once)
      int m0 = r0, m1 = r0 + R;
      if (b == res_b) {
        if (r0 >= res_r0) m0 = max(r0, res_r0 + R);
        else m1 = min(r0 + R, res_r0);
      }
      if (m0 < m1) {
        const int first = m0 % R;
        const int run = min(m1 - m0, R - first);
        const Tv* src = xb + static_cast<size_t>(m0) * row_vals;
        const size_t row_bytes = row_vals * sizeof(Tv);
        bulk = ((reinterpret_cast<uintptr_t>(src) | row_bytes) & 15) == 0;
        if (bulk) {
          if (threadIdx.x == 0) {
            bulk_expect(&s_bar, static_cast<uint32_t>((m1 - m0) * row_bytes));
            bulk_load(ring + first * row_vals, src,
                      static_cast<uint32_t>(run * row_bytes), &s_bar);
            if (run < m1 - m0) {
              bulk_load(ring, src + run * row_vals,
                        static_cast<uint32_t>((m1 - m0 - run) * row_bytes),
                        &s_bar);
            }
          }
        } else {
          const size_t vals = static_cast<size_t>(m1 - m0) * row_vals;
          const size_t wrap = (R - first) * row_vals;
          for (size_t i = threadIdx.x; i < vals; i += kThreads) {
            ring[i < wrap ? first * row_vals + i : i - wrap] = src[i];
          }
        }
      }
      res_b = b;
      res_r0 = r0;

      // pass 1b: each corner's byte offset (corner_offsets)
      for (int s = threadIdx.x; s < n; s += kThreads) {
        const int4 yx = offs[s];
        offs[s] = corner_offsets(wts[s], yx.x, yx.y, r0, R, r0 % R, W,
                                 texel_bytes, zero, xb, onmap, fallback);
      }
      __syncthreads();
    }
    if (bulk) {
      bulk_wait(&s_bar, phase);
      phase ^= 1;
    }

    // the next tile's coordinates into L2 while this one is swept: its 3 *
    // K runs of np floats, one prefetch a 128-byte line
    if (t + 1 < t_end) {
      const int b1 = static_cast<int>((t + 1) / tiles);
      const int p1 = static_cast<int>(t + 1 - static_cast<long long>(b1) * tiles) * TP;
      const int np1 = min(TP, P - p1);
      const size_t c1 = static_cast<size_t>(b1) * K * P + p1;
      const int lines = np1 / 32 + 2;  // of a run, however it is aligned
      for (int i = threadIdx.x; i < 3 * K * lines; i += kThreads) {
        const int a = i / (K * lines);
        const int k = (i - a * K * lines) / lines;
        const int l = i - (a * K + k) * lines;
        const float* run = (a == 0 ? ys : a == 1 ? xs : scale) + c1 +
                           static_cast<size_t>(k) * P;
        prefetch_l2(run + min(32 * l, np1 - 1));
      }
    }

    // the sweep: a unit is vectors v, v + part, ... (kPer of them, part =
    // ceil(nv / kPer), those past nv absent) of one sample, so that its
    // slot is read and its corners' addresses formed once for kPer
    // vectors; thread u takes units u, u + kThreads, ..., kUnroll at a
    // time, unit j being unit j % part of sample j / part
    Tv* ob = out + (static_cast<size_t>(b) * P + p0) * K * C;
    const int part = (nv + kPer - 1) / kPer;
    const int pb = part * kVec * static_cast<int>(sizeof(Tv));  // bytes
    const int total = n * part;
    const int ds = kThreads / part;
    const int dv = kThreads - ds * part;
    int s = threadIdx.x / part;
    int v = threadIdx.x - s * part;
    for (int j = threadIdx.x; j < total; j += kUnroll * kThreads) {
      int su[kUnroll], vu[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        su[u] = j + u * kThreads < total ? s : -1;
        vu[u] = v;
        s += ds;
        v += dv;
        if (v >= part) {
          v -= part;
          ++s;
        }
      }
      Raw r[kUnroll][4][kPer];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int4 o4 = su[u] >= 0 ? offs[su[u]] : make_int4(zero, zero, zero, zero);
        const int o[4] = {o4.x, o4.y, o4.z, o4.w};
        const int lane = vu[u] * kVec * static_cast<int>(sizeof(Tv));  // bytes
        const char* gl = reinterpret_cast<const char*>(xb) + lane;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // a 32 x 32 -> 64-bit multiply-add for the fallback's address
          const char* p = o[c] >= 0
                              ? reinterpret_cast<const char*>(sm) + o[c] + lane
                              : gl + static_cast<unsigned long long>(
                                         static_cast<unsigned>(~o[c])) *
                                         static_cast<unsigned>(texel_bytes);
#pragma unroll
          for (int m = 0; m < kPer; ++m) {
            // load m takes piece (m + s) % kPer, so that the samples a
            // quarter warp spans read different banks; an absent vector
            // rereads the first
            const int piece = (m + su[u]) & (kPer - 1);
            const char* q = vu[u] + piece * part < nv ? p + piece * pb : p;
            r[u][c][m] = o[c] >= 0 ? V::lds(reinterpret_cast<const Tv*>(q))
                                   : V::ldg(reinterpret_cast<const Tv*>(q));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (su[u] < 0) continue;
        const float4 w4 = wts[su[u]];
        const float cw[4] = {w4.x, w4.y, w4.z, w4.w};
        const float sc = scl[su[u]];
        Tv* dst = ob + static_cast<size_t>(su[u]) * C + vu[u] * kVec;
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          const int piece = (m + su[u]) & (kPer - 1);
          if (vu[u] + piece * part >= nv) continue;
          float acc[kVec];
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float f[kVec];
            V::unpack(r[u][c][m], f);
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[i] = fmaf(cw[c], f[i], acc[i]);
          }
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] *= sc;
          V::store(dst + piece * part * kVec, acc);
        }
      }
    }
    __syncthreads();
  }

  if (stats != nullptr) {
    atomicAdd(&s_fallback, fallback);
    atomicAdd(&s_onmap, onmap);
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(stats, s_fallback);
      atomicAdd(stats + 1, s_onmap);
    }
  }
}

template <typename V>
int launch(const void* x, const float* ys, const float* xs,
           const float* scale, void* out, unsigned long long* stats, int B,
           int H, int W, int C, int K, int P, int TP, int R, int blocks,
           cudaStream_t stream) {
  using T = typename V::T;
  if (B == 0 || P == 0 || K == 0 || C / V::kVec == 0) return 0;
  const int tiles = (P + TP - 1) / TP;
  const long long total = static_cast<long long>(B) * tiles;
  const size_t smem =
      align16(static_cast<size_t>(R * W + 1) * C * sizeof(T)) +
      static_cast<size_t>(TP) * K * kSlotBytes;
  auto kernel = R > 0 || C / V::kVec >= 16 ? taps_fwd_kernel<V, 4, 1>
                                            : taps_fwd_kernel<V, 2, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks < total ? blocks : total), kThreads,
           smem, stream>>>(
      static_cast<const T*>(x), ys, xs, scale, static_cast<T*>(out), stats, H,
      W, C, K, P, TP, R, tiles, total);
  return static_cast<int>(cudaGetLastError());
}

// The launch of either entry; vec selects the lane type of dtype (0 =
// float32, 1 = bfloat16) that moves 16-byte vectors, else the scalar one.
int forward(const void* x, const float* ys, const float* xs,
            const float* scale, void* out, void* stats, int B, int H, int W,
            int C, int K, int P, int tile, int rows, int blocks, int dtype,
            int vec, cudaStream_t st) {
  unsigned long long* counters = static_cast<unsigned long long*>(stats);
  if (tile <= 0 || rows < 0 || rows > H || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return vec ? launch<F32x4>(x, ys, xs, scale, out, counters, B, H, W, C, K,
                               P, tile, rows, blocks, st)
               : launch<F32x1>(x, ys, xs, scale, out, counters, B, H, W, C, K,
                               P, tile, rows, blocks, st);
  }
  if (dtype == 1) {
    return vec ? launch<Bf16x8>(x, ys, xs, scale, out, counters, B, H, W, C,
                                K, P, tile, rows, blocks, st)
               : launch<Bf16x1>(x, ys, xs, scale, out, counters, B, H, W, C,
                                K, P, tile, rows, blocks, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K1f. dtype: 0 = float32, 1 = bfloat16. x (B, H, W, C) in that type; ys,
// xs, scale (B, K, P) f32; out (B, P, K*C) in x's type, written whole.
// stats, where not null, are 2 zeroed counters: the corners on the map read
// from global memory (outside their tile's window), and all corners on the
// map. tile (TP), rows (R) and blocks (G, the persistent grid) are the
// plan's (ops/hat_sample.py:taps_fwd_plan); the shared memory per block,
// align16((R*W + 1) * C * elt) + TP * K * 36 bytes, follows from them. The
// caller guarantees contiguous tensors, 16-byte aligned x and out and C %
// 8 == 0. Returns the first CUDA error of the launch.
extern "C" int hat_sample_taps_fwd(const void* x, const float* ys,
                                   const float* xs, const float* scale,
                                   void* out, void* stats, int B, int H, int W,
                                   int C, int K, int P, int tile, int rows,
                                   int blocks, int dtype, void* stream) {
  return forward(x, ys, xs, scale, out, stats, B, H, W, C, K, P, tile, rows,
                 blocks, dtype, 1, static_cast<cudaStream_t>(stream));
}

// K2f: the same with one tap: ys, xs, scale (B, N); out (B, N, C); any C
// >= 1; the plan's (ops/hat_sample.py:flat_fwd_plan) tile of samples, rows
// and blocks. vec: 1 when C is a multiple of 4 (f32) or 8 (bf16) and x and
// out are 16-byte aligned, else 0 (one channel per lane step).
extern "C" int hat_sample_flat_fwd(const void* x, const float* ys,
                                   const float* xs, const float* scale,
                                   void* out, void* stats, int B, int H, int W,
                                   int C, int N, int tile, int rows, int blocks,
                                   int dtype, int vec, void* stream) {
  return forward(x, ys, xs, scale, out, stats, B, H, W, C, 1, N, tile, rows,
                 blocks, dtype, vec, static_cast<cudaStream_t>(stream));
}
