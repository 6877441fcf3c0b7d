// Modulated bilinear sampling, backward: the gradient of the DCNv2
// samplers in csrc/hat_sample_taps.cu (tap-grouped and flat). One kernel
// serves both.
//
// Replaces minddet_tpu/ops/hat_sample.py:_bwd_taps_kernel (K1b, reached
// through _bwd_taps_pallas <- the custom_vjp of hat_sample_2d_taps <-
// ops/dcn.py) through hat_sample_taps_bwd, and hat_sample.py:_bwd_kernel
// (K2b, reached through _bwd_pallas <- the custom_vjp of hat_sample_2d <-
// ops/dcn.py's flat branch, DCN layers whose Cin is not a multiple of 128)
// through hat_sample_flat_bwd. The flat samples (B, N) are position-major
// (n = p * K + k) and the flat g (B, N, C) has the memory of a tap-grouped
// g (B, P, K*C): the flat backward is the tap-grouped one with one tap,
// K = 1 and P = N.
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
// dxs are forward differences. The TPU kernels' hat subgradient is zero
// there; that is not carried over. Corners are tested against the map in
// float, so +-1e6, +-3e9 and NaN contribute nothing.
//
// What bounds it on an H100: memory. It reads g once (B*P*K*C values), the
// x rows the samples touch and the three (B,K,P) f32 coordinate arrays,
// and writes dx and the three (B,K,P) f32 outputs. About 16 flops per g
// value, far below the memory rate. What it must avoid is an f32 atomic in
// global memory for every corner's scale*w*g: 604 M float4 reductions per
// call at (B,H,W,C) = (128,64,64,128), 75 M corners of 16 float4 each in
// the flat case at (128,128,128,64), all through L2.
//
// Design: one kernel, taps_bwd_kernel, sums dx per tile in shared memory
// before it goes out, as the TPU kernel sums a tile's union window of map
// rows in a scratch (_meta_taps), and takes the coordinate gradients from
// the same reads. A block takes TP consecutive positions p with all K taps
// and all C channels, so the dots need neither partial sums across blocks
// nor atomics, and repeat bit for bit.
// - The window: R whole map rows (all H where they fit), found from the
//   block's own samples: a block reduction of floor(ys) over the samples
//   that can touch the map (min, max, sum), then the rows [min, min+R)
//   where they fit, else R rows centred on the mean; clamped into the map.
//   Nothing assumes stride 1 or 3x3 taps.
// - Pass 1 counts the tile's corners per window texel (shared int32
//   atomics, native); a block scan makes bucket starts; pass 2 fills the
//   buckets with (corner slot e, scale * w). A corner on the map but
//   outside the window (the fallback; spread-80 coordinates send many
//   there) is done at once by its sample's thread: its dot from x in
//   global memory, its scale * w * g by atomicAdd into the scratch.
// - Pass 3: a group of G lanes per window texel (G the power of two >=
//   C/VEC, at most 32), lane j on the texel's vectors j, j+G, ...,
//   walks the texel's bucket: it adds scale * w * g into registers and dots
//   g with the texel's row of x, read once; the group sums each dot with an
//   xor tree, and its first lane adds it into the corner's slot. Then the
//   texel's sums go into the f32 scratch with one float4 atomicAdd per
//   4 channels (red.global.add.v4.f32). A touched texel takes one reduction
//   per tile instead of one per corner (36 corners per texel at spread
//   1.5); no f32 atomic touches shared memory (on sm_90 those compile to
//   compare-and-swap loops, ATOMS.CAST.SPIN). g is read once per corner,
//   from L2 after the first.
// - Pass 4: each sample's thread forms dys, dxs and dscale from its four
//   dots (0 for a corner off the map). Every dot is one lane's fixed-order
//   sum and one fixed xor tree, or one thread's sum over the channels, so
//   the three outputs repeat bit for bit.
// TP and R come from the wrapper's plan (ops/hat_sample.py:
// taps_bwd_plan, flat_bwd_plan), which keeps a block within ~110 KB so
// that two 512-thread blocks fit on an SM; where not one window row fits
// it gives R = 0 and every corner takes the fallback. dx is summed in f32 in no fixed order.
// For a bf16 x, flush_bf16_kernel then rounds the scratch to dx once; for
// an f32 x the scratch is dx.
//
// Widths: a lane moves 16-byte vectors (8 bf16 or 4 f32 channels) where C
// is a whole number of them and the rows are 16-byte aligned; otherwise one
// channel (F32x1, Bf16x1: scalar loads, scalar atomics into the scratch),
// so the flat entry takes any C >= 1. Offsets into g, x, the coordinates
// and the scratch are 64-bit: a launch may hold more than 2**31 values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // flush_bf16_kernel
constexpr int kWindowThreads = 512;  // taps_bwd_kernel
constexpr int kUnroll = 4;           // corners in flight per lane, pass 3

struct F32x4 {
  using T = float;
  using Raw = float4;  // one 16-byte vector as loaded
  static constexpr int kVec = 4;
  static __device__ __forceinline__ Raw raw(const T* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void load(const T* p, float* v) {
    unpack(raw(p), v);
  }
};

struct Bf16x8 {
  using T = __nv_bfloat16;
  using Raw = uint4;  // one 16-byte vector as loaded
  static constexpr int kVec = 8;
  static __device__ __forceinline__ Raw raw(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void load(const T* p, float* v) {
    unpack(raw(p), v);
  }
};

// one channel per lane step: any C, any alignment
struct F32x1 {
  using T = float;
  using Raw = float;
  static constexpr int kVec = 1;
  static __device__ __forceinline__ Raw raw(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) { v[0] = q; }
  static __device__ __forceinline__ void load(const T* p, float* v) { v[0] = __ldg(p); }
};

struct Bf16x1 {
  using T = __nv_bfloat16;
  using Raw = unsigned short;
  static constexpr int kVec = 1;
  static __device__ __forceinline__ Raw raw(const T* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    v[0] = __bfloat162float(__ushort_as_bfloat16(q));
  }
  static __device__ __forceinline__ void load(const T* p, float* v) {
    unpack(raw(p), v);
  }
};

// dst[0, n) += v[0, n) with reductions in global memory: float4 ones where
// n % 4 == 0 (dst 16-byte aligned), else one per value
template <int n>
__device__ __forceinline__ void red_add(float* dst, const float* v) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int q = 0; q < n; q += 4) {
      atomicAdd(reinterpret_cast<float4*>(dst + q),
                make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]));
    }
  } else {
#pragma unroll
    for (int q = 0; q < n; ++q) atomicAdd(dst + q, v[q]);
  }
}

// The four corners of (y, xx): rows, columns, bilinear weights and whether
// each lies on the (H, W) map; bounds are tested in float so far-out
// coordinates never reach an int conversion.
struct Corners {
  float fy, fx;
  float w[4];
  bool inb[4];
  int row[4], col[4];
  __device__ __forceinline__ Corners(float y, float xx, int H, int W) {
    const float y0 = floorf(y);
    const float x0 = floorf(xx);
    fy = y - y0;
    fx = xx - x0;
    const float cy[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
    const float cx[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
    w[0] = (1.f - fy) * (1.f - fx);
    w[1] = (1.f - fy) * fx;
    w[2] = fy * (1.f - fx);
    w[3] = fy * fx;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      inb[c] = cy[c] >= 0.f && cy[c] < H && cx[c] >= 0.f && cx[c] < W;
      row[c] = inb[c] ? static_cast<int>(cy[c]) : 0;
      col[c] = inb[c] ? static_cast<int>(cx[c]) : 0;
    }
  }
};

// Exclusive scan of cnt[0, n) into start[0, n], n = start[n] the total;
// cnt reset to 0. Every thread of the block takes part.
__device__ void block_exclusive_scan(int* cnt, int* start, int n,
                                     int* warp_sums) {
  constexpr int kWarps = kWindowThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += kWindowThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n ? cnt[i] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int t = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += y;
      }
      if (lane < kWarps) warp_sums[lane] = t;
    }
    __syncthreads();
    if (i < n) {
      start[i] = carry + x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
      cnt[i] = 0;
    }
    carry += warp_sums[kWarps - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) start[n] = carry;
}

// Adds the group's sums of four corners' partial dots into dot[e[u]]. A
// transposed butterfly: the first level halves the four values each lane
// carries, the second halves the two, the rest sum one; 5 shuffles for the
// four corners at G = 16 where the plain xor tree takes 16. Each sum is
// the plain tree's, bit for bit (a + b == b + a), so a corner's dot does
// not depend on which corners share its batch.
__device__ __forceinline__ void reduce4(const float* part, const int* e,
                                        float* dot, int lane, int group,
                                        unsigned mask) {
  if (group == 1) {
#pragma unroll
    for (int u = 0; u < 4; ++u) dot[e[u]] += part[u];
    return;
  }
  int o = group >> 1;
  bool up = lane & o;
  const float q0 = (up ? part[2] : part[0]) +
                   __shfl_xor_sync(mask, up ? part[0] : part[2], o);
  const float q1 = (up ? part[3] : part[1]) +
                   __shfl_xor_sync(mask, up ? part[1] : part[3], o);
  const int e0 = up ? e[2] : e[0];
  const int e1 = up ? e[3] : e[1];
  if (group == 2) {
    dot[e0] += q0;
    dot[e1] += q1;
    return;
  }
  o >>= 1;
  up = lane & o;
  float r = (up ? q1 : q0) + __shfl_xor_sync(mask, up ? q0 : q1, o);
  const int mine = up ? e1 : e0;
  const int low = o - 1;  // lanes that differ below o hold the same sum
  for (o >>= 1; o > 0; o >>= 1) r += __shfl_xor_sync(mask, r, o);
  if ((lane & low) == 0) dot[mine] += r;
}

// Block: positions [tile*TP, tile*TP + TP) of image b, all K taps (tile
// samples s = p * K + k in g's order, corner slots e = 4 * s + c) and all
// C channels; a window of R map rows x W texels from row r0. Dynamic
// shared memory:
// start (R*W + 1) and cnt (R*W) int32, then ent (int32), wt and dot (f32),
// TP*K*4 each: the window's corners bucketed by texel as (e, scale * w),
// and every corner's dot <g, x row>.
template <typename V>
__global__ void __launch_bounds__(kWindowThreads, 2)
taps_bwd_kernel(const typename V::T* __restrict__ g,
                const typename V::T* __restrict__ x,
                const float* __restrict__ ys, const float* __restrict__ xs,
                const float* __restrict__ scale, float* __restrict__ acc,
                float* __restrict__ dys, float* __restrict__ dxs,
                float* __restrict__ dsc, unsigned long long* __restrict__ stats,
                int H, int W, int C, int K, int P, int TP, int R, int tiles,
                int log2g) {
  constexpr int kVec = V::kVec;
  extern __shared__ int sm[];
  __shared__ int s_min, s_max, s_count, s_r0, s_tmin, s_tmax;
  __shared__ unsigned long long s_sum, s_fallback, s_added;
  __shared__ int s_warp[kWindowThreads / 32];

  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - b * tiles) * TP;
  const int np = min(TP, P - p0);
  const int nv = C / kVec;
  const int n = np * K;  // samples of the tile
  const int nw = R * W;  // texels of the window
  int* start = sm;
  int* cnt = start + nw + 1;
  int* ent = cnt + nw;
  float* wt = reinterpret_cast<float*>(ent + TP * K * 4);
  float* dot = wt + TP * K * 4;
  const size_t cbase = static_cast<size_t>(b) * K * P + p0;
  const float* ysb = ys + cbase;
  const float* xsb = xs + cbase;
  const float* scb = scale + cbase;
  const typename V::T* xb = x + static_cast<size_t>(b) * H * W * C;
  // tile sample s's g rows start at gb + s * C; its coordinates lie at
  // index k * P + p past the tile's first
  const typename V::T* gb = g + (static_cast<size_t>(b) * P + p0) * K * C;
  auto coord = [&](int s) {
    const int p = s / K;
    return static_cast<size_t>(s - p * K) * P + p;
  };

  if (threadIdx.x == 0) {
    s_min = H;
    s_max = -2;
    s_count = 0;
    s_sum = 0;
    s_fallback = 0;
    s_added = 0;
    s_tmin = nw;
    s_tmax = -1;
  }
  for (int i = threadIdx.x; i < nw; i += kWindowThreads) cnt[i] = 0;
  for (int i = threadIdx.x; i < 4 * n; i += kWindowThreads) dot[i] = 0.f;
  __syncthreads();
  // the window: the rows of the samples that can touch the map, floor(ys)
  // in [-1, H-1] with floor(xs) in [-1, W-1]
  if (R > 0 && R < H) {
    int lmin = H, lmax = -2, lcount = 0;
    unsigned long long lsum = 0;
    for (int s = threadIdx.x; s < n; s += kWindowThreads) {
      const size_t ci = coord(s);
      const float y0 = floorf(ysb[ci]);
      const float x0 = floorf(xsb[ci]);
      if (y0 >= -1.f && y0 <= H - 1 && x0 >= -1.f && x0 <= W - 1) {
        const int iy = static_cast<int>(y0);
        lmin = min(lmin, iy);
        lmax = max(lmax, iy);
        lsum += static_cast<unsigned long long>(iy + 1);
        ++lcount;
      }
    }
    if (lcount > 0) {
      atomicMin(&s_min, lmin);
      atomicMax(&s_max, lmax);
      atomicAdd(&s_sum, lsum);
      atomicAdd(&s_count, lcount);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int r0 = 0;
    if (R > 0 && R < H && s_count > 0) {
      const int lo = max(s_min, 0);
      const int hi = min(s_max + 1, H - 1);
      if (hi - lo + 1 <= R) {
        r0 = lo;
      } else {
        // the mean corner row is the mean floor(ys) + 1/2
        const long long mean =
            static_cast<long long>((s_sum + s_count / 2) / s_count) - 1;
        r0 = static_cast<int>(mean) - (R - 2) / 2;
      }
      r0 = max(0, min(r0, H - R));
    }
    s_r0 = r0;
  }
  __syncthreads();
  const int r0 = s_r0;

  // pass 1: count the window's corners per texel; a corner on the map but
  // outside the window (the fallback) gets its dot from x in global memory
  // and adds scale * w * g straight into the scratch
  unsigned long long fallback = 0, added = 0;
  int lmin = nw, lmax = -1;
  for (int s = threadIdx.x; s < n; s += kWindowThreads) {
    const size_t ci = coord(s);
    const float sc = scb[ci];
    const Corners cr(ysb[ci], xsb[ci], H, W);
    bool out[4];
    bool far = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      out[c] = false;
      if (!cr.inb[c]) continue;
      const bool adds = sc * cr.w[c] != 0.f;
      added += adds;
      const int wr = cr.row[c] - r0;
      if (wr >= 0 && wr < R) {
        const int t = wr * W + cr.col[c];
        atomicAdd(cnt + t, 1);
        lmin = min(lmin, t);
        lmax = max(lmax, t);
      } else {
        out[c] = far = true;
        fallback += adds;
      }
    }
    if (far) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int v = 0; v < nv; ++v) {
        float gv[kVec];
        V::load(gb + static_cast<size_t>(s) * C + v * kVec, gv);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!out[c]) continue;
          const size_t off =
              (static_cast<size_t>(cr.row[c]) * W + cr.col[c]) * C + v * kVec;
          float xv[kVec];
          V::load(xb + off, xv);
#pragma unroll
          for (int q = 0; q < kVec; ++q) d[c] = fmaf(gv[q], xv[q], d[c]);
          const float a = sc * cr.w[c];
          if (a == 0.f) continue;
          float ag[kVec];
#pragma unroll
          for (int q = 0; q < kVec; ++q) ag[q] = a * gv[q];
          red_add<kVec>(acc + static_cast<size_t>(b) * H * W * C + off, ag);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (out[c]) dot[4 * s + c] = d[c];
      }
    }
  }
  if (lmax >= 0) {
    atomicMin(&s_tmin, lmin);
    atomicMax(&s_tmax, lmax);
  }
  if (stats != nullptr) {
    atomicAdd(&s_fallback, fallback);
    atomicAdd(&s_added, added);
  }
  __syncthreads();
  block_exclusive_scan(cnt, start, nw, s_warp);
  // pass 2: bucket the window's corners by texel
  for (int s = threadIdx.x; s < n; s += kWindowThreads) {
    const size_t ci = coord(s);
    const float sc = scb[ci];
    const Corners cr(ysb[ci], xsb[ci], H, W);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int wr = cr.row[c] - r0;
      if (!cr.inb[c] || wr < 0 || wr >= R) continue;
      const int slot = start[wr * W + cr.col[c]] + atomicAdd(cnt + wr * W + cr.col[c], 1);
      ent[slot] = 4 * s + c;
      wt[slot] = sc * cr.w[c];
    }
  }
  __syncthreads();
  // pass 3: a group of G lanes per texel, lane j on its 16-byte vectors j,
  // j + G, ...: for each corner of the texel's bucket it adds scale * w * g
  // into registers and dots g with the texel's row of x, read once; the
  // group sums each dot with an xor tree (fixed, so every corner's dot
  // repeats bit for bit) and one lane adds it into dot[e]. Four corners at
  // a time, so that four rows of g are in flight, their dots summed by
  // reduce4. Then the
  // texel's sums go into the scratch with float4 atomicAdd.
  {
    const int group = 1 << log2g;
    const int lane = threadIdx.x & (group - 1);
    const unsigned mask =
        group == 32 ? 0xffffffffu
                    : ((1u << group) - 1u) << ((threadIdx.x & 31) & ~(group - 1));
    const int groups = kWindowThreads >> log2g;
    const int tmax = s_tmax;
    const typename V::Raw zero = {};
    for (int t = s_tmin + (threadIdx.x >> log2g); t <= tmax; t += groups) {
      const int j0 = start[t];
      const int j1 = start[t + 1];
      if (j0 == j1) continue;
      const size_t toff = (static_cast<size_t>(r0) * W + t) * C;
      for (int vb = 0; vb < nv; vb += group) {
        const int v = vb + lane;
        const bool on = v < nv;
        float xf[kVec], sum[kVec];
        V::unpack(on ? V::raw(xb + toff + v * kVec) : zero, xf);
#pragma unroll
        for (int q = 0; q < kVec; ++q) sum[q] = 0.f;
        int j = j0;
        for (; j + kUnroll <= j1; j += kUnroll) {
          int e[kUnroll];
          float a[kUnroll], part[kUnroll];
          typename V::Raw r[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            e[u] = ent[j + u];
            a[u] = wt[j + u];
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            r[u] = on ? V::raw(gb + static_cast<size_t>(e[u] >> 2) * C + v * kVec)
                      : zero;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            float gf[kVec];
            V::unpack(r[u], gf);
            part[u] = 0.f;
#pragma unroll
            for (int q = 0; q < kVec; ++q) {
              sum[q] = fmaf(a[u], gf[q], sum[q]);
              part[u] = fmaf(gf[q], xf[q], part[u]);
            }
          }
          reduce4(part, e, dot, lane, group, mask);
        }
        for (; j < j1; ++j) {
          const int e = ent[j];
          float gf[kVec];
          V::unpack(on ? V::raw(gb + static_cast<size_t>(e >> 2) * C + v * kVec)
                       : zero, gf);
          float part = 0.f;
#pragma unroll
          for (int q = 0; q < kVec; ++q) {
            sum[q] = fmaf(wt[j], gf[q], sum[q]);
            part = fmaf(gf[q], xf[q], part);
          }
          for (int o = group >> 1; o > 0; o >>= 1) part += __shfl_xor_sync(mask, part, o);
          if (lane == 0) dot[e] += part;
        }
        if (on) {
          // one reduction per 4 values (per value for a scalar lane),
          // skipped where they are all zero
          constexpr int kRed = kVec < 4 ? kVec : 4;
          float* dst = acc + static_cast<size_t>(b) * H * W * C + toff + v * kVec;
#pragma unroll
          for (int q = 0; q < kVec; q += kRed) {
            bool nonzero = false;
#pragma unroll
            for (int i = 0; i < kRed; ++i) nonzero |= sum[q + i] != 0.f;
            if (nonzero) red_add<kRed>(dst + q, sum + q);
          }
        }
      }
    }
  }
  __syncthreads();
  // pass 4: the coordinate gradients from the four dots
  for (int s = threadIdx.x; s < n; s += kWindowThreads) {
    const size_t ci = coord(s);
    const float sc = scb[ci];
    const float y = ysb[ci], xx = xsb[ci];
    const float fy = y - floorf(y);
    const float fx = xx - floorf(xx);
    const float* d = dot + 4 * s;
    const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
    const float w10 = fy * (1.f - fx), w11 = fy * fx;
    dsc[cbase + ci] = w00 * d[0] + w01 * d[1] + w10 * d[2] + w11 * d[3];
    dys[cbase + ci] = sc * ((1.f - fx) * (d[2] - d[0]) + fx * (d[3] - d[1]));
    dxs[cbase + ci] = sc * ((1.f - fy) * (d[1] - d[0]) + fy * (d[3] - d[2]));
  }
  if (stats != nullptr && threadIdx.x == 0) {
    atomicAdd(stats, s_fallback);
    atomicAdd(stats + 1, s_added);
  }
}

// dx = bf16(acc) over n values, rounded once: 8 per thread where they are
// whole vectors, one per thread for the tail
__global__ void __launch_bounds__(kThreads)
flush_bf16_kernel(const float* __restrict__ acc,
                  __nv_bfloat16* __restrict__ dx, size_t n) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t n8 = n / 8;
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
    const size_t i = 8 * n8 + (t - n8);
    dx[i] = __float2bfloat16_rn(acc[i]);
  }
}

template <typename V>
int launch(const void* g, const void* x, const float* ys, const float* xs,
           const float* scale, float* acc, float* dys, float* dxs,
           float* dsc, unsigned long long* stats, int B, int H, int W, int C,
           int K, int P, int TP, int R, int smem, cudaStream_t stream) {
  const int nv = C / V::kVec;
  if (B == 0 || P == 0 || K == 0 || nv == 0) return 0;
  const int tiles = (P + TP - 1) / TP;
  int log2g = 0;
  while ((1 << log2g) < nv && log2g < 5) ++log2g;
  cudaError_t err = cudaFuncSetAttribute(
      taps_bwd_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  taps_bwd_kernel<V><<<static_cast<unsigned>(static_cast<uint64_t>(B) * tiles),
                       kWindowThreads, smem, stream>>>(
      static_cast<const typename V::T*>(g),
      static_cast<const typename V::T*>(x), ys, xs, scale, acc, dys, dxs, dsc,
      stats, H, W, C, K, P, TP, R, tiles, log2g);
  return static_cast<int>(cudaGetLastError());
}

// The launches of either entry; vec selects the lane type of dtype (0 =
// float32, 1 = bfloat16) that moves 16-byte vectors, else the scalar one.
int backward(const void* g, const void* x, const float* ys, const float* xs,
             const float* scale, float* acc, void* dx, float* dys, float* dxs,
             float* dsc, void* stats, int B, int H, int W, int C, int K,
             int P, int tile, int rows, int smem, int dtype, int vec,
             cudaStream_t st) {
  unsigned long long* counters = static_cast<unsigned long long*>(stats);
  if (tile <= 0 || rows < 0 || rows > H) return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (dtype == 0) {
    if (dx != static_cast<void*>(acc)) return static_cast<int>(cudaErrorInvalidValue);
    err = vec ? launch<F32x4>(g, x, ys, xs, scale, acc, dys, dxs, dsc, counters,
                              B, H, W, C, K, P, tile, rows, smem, st)
              : launch<F32x1>(g, x, ys, xs, scale, acc, dys, dxs, dsc, counters,
                              B, H, W, C, K, P, tile, rows, smem, st);
  } else if (dtype == 1) {
    err = vec ? launch<Bf16x8>(g, x, ys, xs, scale, acc, dys, dxs, dsc, counters,
                               B, H, W, C, K, P, tile, rows, smem, st)
              : launch<Bf16x1>(g, x, ys, xs, scale, acc, dys, dxs, dsc, counters,
                               B, H, W, C, K, P, tile, rows, smem, st);
    const size_t n = static_cast<size_t>(B) * H * W * C;
    if (err == 0 && n > 0) {
      const size_t threads = n / 8 + n % 8;
      flush_bf16_kernel<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                          kThreads, 0, st>>>(
          acc, static_cast<__nv_bfloat16*>(dx), n);
      err = static_cast<int>(cudaGetLastError());
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return err;
}

}  // namespace

// K1b. dtype: 0 = float32, 1 = bfloat16. g (B, P, K*C) and x (B, H, W, C)
// in that type; ys, xs, scale (B, K, P) f32; acc (B, H, W, C) f32, zeroed
// by the caller; dys, dxs, dsc (B, K, P) f32, written whole. For float32,
// dx must be acc (the scratch is the result); for bfloat16 dx (B, H, W, C)
// receives acc rounded. stats, where not null, are 2 zeroed counters: the
// corners added by the global fallback, and all corners added. tile (TP),
// rows (R) and smem ((2 * R * W + 1) * 4 + TP * K * 48 bytes) are the
// plan's. The caller guarantees contiguous tensors, 16-byte aligned rows,
// C % 8 == 0 and fewer than 2**31 blocks (B * ceil(P / TP)). Returns the
// first CUDA error of the launches.
extern "C" int hat_sample_taps_bwd(const void* g, const void* x,
                                   const float* ys, const float* xs,
                                   const float* scale, float* acc, void* dx,
                                   float* dys, float* dxs, float* dsc,
                                   void* stats, int B, int H, int W, int C,
                                   int K, int P, int tile, int rows, int smem,
                                   int dtype, void* stream) {
  return backward(g, x, ys, xs, scale, acc, dx, dys, dxs, dsc, stats, B, H, W,
                  C, K, P, tile, rows, smem, dtype, 1,
                  static_cast<cudaStream_t>(stream));
}

// K2b: the same with one tap: g (B, N, C); ys, xs, scale, dys, dxs, dsc
// (B, N); any C >= 1; the plan's (ops/hat_sample.py:flat_bwd_plan) tile
// of samples, rows and smem. vec: 1 when C is a multiple of 4 (f32) or 8
// (bf16) and g and x are 16-byte aligned, else 0 (one channel per lane
// step).
extern "C" int hat_sample_flat_bwd(const void* g, const void* x,
                                   const float* ys, const float* xs,
                                   const float* scale, float* acc, void* dx,
                                   float* dys, float* dxs, float* dsc,
                                   void* stats, int B, int H, int W, int C,
                                   int N, int tile, int rows, int smem,
                                   int dtype, int vec, void* stream) {
  return backward(g, x, ys, xs, scale, acc, dx, dys, dxs, dsc, stats, B, H, W,
                  C, 1, N, tile, rows, smem, dtype, vec,
                  static_cast<cudaStream_t>(stream));
}
