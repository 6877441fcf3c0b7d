// Backward of the bounded segment max of a sorted point stream
// (seg_full_max.cu): the gradient of "each pillar's max back onto every
// point of the pillar" with respect to the points.
//
// Replaces minddet_tpu/ops/seg_pallas.py:129 _bwd_kernel (reached through
// _run_bwd <- _op_bwd, the VJP of seg_full_max_bounded <-
// readers/pillar_encoder.py: PFNLayer.stream of a non-last layer).
//
// x and dx are (B, N, C) in f32 or bf16, contiguous; g, the gradient of the
// forward's output, is (B, N, C) in x's type with any row stride (the
// stream PFN's torch.cat hands the second half of a (B, N, 2C) gradient);
// first and last are (B, N) bytes (0/1) as in the forward. A row r is
// covered where its segment's last kept row l is the nearest `last` at or
// after r, fewer than `bound` rows away, with no segment head in (r, l].
// Its segment's rows are [h, l], h the nearest head at or before l but at
// most `bound` - 1 rows back, and per channel
//
//   m     = max over rows j in [h, l] of x[b, j, :]   (the forward's value)
//   dx[r] = (x[r] == m) * (sum over j in [h, l] of g[j]) / #{j : x[j] == m}
//
// the reduce-max convention: a tie shares the gradient evenly. Every other
// row gets 0, and g at such rows is not summed: the forward is the
// constant 0 there. Sums and counts are f32; the equality is taken on the
// values widened to f32, exact for bf16.
//
// What bounds it on an H100: memory. The least it must move is x and g at
// the covered rows, dx at every row and the two flag planes; m is the max
// of x values read anyway, and a max is exact, so the kernel takes it
// itself and reads no forward output. On a voxelizer stream about 31 % of
// the rows are covered (the kept points; "first_come" puts the kept
// pillars first, then the dropped ones and the invalid tail), and most
// segments hold one row.
//
// Design: a block of 128 threads owns a tile of `tile` rows of one sample
// and `chunk` 16-byte vectors of each row (the wrapper's plan: a whole row
// of C = 32, tile x chunk = 512 vectors; smaller tiles where the grid
// would not fill the card).
//  1. It copies the flag bytes of the tile and of `bound` - 1 rows of halo
//     on each side into shared memory, each byte once per block. A segment
//     holds at most `bound` rows, so the window sees whole every segment
//     that covers a row of the tile. A tile with no `last` in its rows or
//     the halo after them has no covered row: it writes zeros with 16-byte
//     stores and reads no data (69 % of the tiles of a voxelizer stream).
//  2. Otherwise it starts cp.async copies of x and g at its rows into
//     shared memory, and while they fly one thread per row finds the row's
//     l (or "not covered"); each run of rows with one l is an item. A
//     ballot and a prefix over the warps list the items in row order: a
//     one-row segment (h == l) by its row, a longer one by its first tile
//     row, l and h.
//  3. Rows that are not covered get zeros, with no data read.
//  4. The halo rows of the first and last segments are copied, and the
//     block waits for every copy.
//  5. A one-row segment's dx is g + 0 where x is not NaN (its max is x, its
//     count 1, its sum 0 + g): no walk. A longer one is walked once per
//     half vector (8 bytes: two threads share a vector, which halves the
//     longest walk), from l back to h with four rows' loads ahead, summing
//     g and keeping the running max of x with the count of the values
//     equal to it: the count of x == m in one pass. dx is then written at
//     the segment's rows in the tile; without a tie the quotient is the
//     sum itself and no division is made. A segment costs O(L) reads, not
//     the O(L^2) of one walk per row; the sums run in the order of the
//     per-row kernel this one replaced (from l back to h), so dx is bit for
//     bit that kernel's. Rows of a segment in the halo are read here and
//     written by the neighbouring tile.
// No atomics: the order is fixed and dx does not change from run to run.
// Row offsets are 32-bit below 2**31 vectors of the widest operand and
// 64-bit from there on (`wide`); the window's and the tile's indices are
// 32-bit.
//
// Measured (scripts/seg_max_bwd_turns.py against the per-row kernel, in
// turns; H100 80GB HBM3, 700 W): see PERF.md, K5b. The per-row kernel
// spent its time walking the flags in every thread and re-summing each
// segment at each of its rows; this one is held by the two round trips a
// covered tile makes (flags, then data) and by its longest walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 8;  // blocks an SM holds: at most 64 registers
constexpr int kRowsAhead = 4;  // rows of a walk loaded before use
constexpr int kDefaultSmem = 48 * 1024;

struct F32x4 {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void unpack(uint4 q, float* v) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  // half a vector: 8 bytes, 2 channels
  static __device__ __forceinline__ void unpack_half(uint2 q, float* v) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
  }
  static __device__ __forceinline__ uint2 pack_half(const float* v) {
    return make_uint2(__float_as_uint(v[0]), __float_as_uint(v[1]));
  }
};

struct Bf16x8 {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void unpack(uint4 q, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return q;
  }
  // half a vector: 8 bytes, 4 channels
  static __device__ __forceinline__ void unpack_half(uint2 q, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint2 pack_half(const float* v) {
    uint2 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return q;
  }
};

// shared memory of a block: per tile row its l (-1: not covered); the
// one-row segments' rows; per longer segment its first tile row, its l and
// its h; the warps' counts of both (16-byte aligned after them); x and g at
// the window's rows for `chunk` vectors; the flag window
__host__ __device__ constexpr long long ints_bytes(int tile) {
  return (20ll * tile + 8ll * kWarps + 15) / 16 * 16;
}
__host__ __device__ constexpr long long smem_bytes(int tile, int bound,
                                                   int chunk) {
  return ints_bytes(tile) +
         (tile + 2ll * (bound - 1)) * (2ll * 16 * chunk + 2);
}

__device__ __forceinline__ void copy16_async(uint4* dst, const uint4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// x, dx: rows of nv 16-byte vectors; g: rows gv vectors apart; a block
// takes `chunk` of a row's vectors (the last chunk may hold fewer)
template <typename V, typename I>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seg_full_max_bwd_kernel(const uint4* __restrict__ x,
                        const uint4* __restrict__ g,
                        const uint8_t* __restrict__ first,
                        const uint8_t* __restrict__ last,
                        uint4* __restrict__ dx, int N, int nv, int gv,
                        int bound, int tile, int tiles, int chunk,
                        int chunks) {
  constexpr int kVec = V::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = bound - 1;
  const int window = tile + 2 * halo;
  int* s_own = reinterpret_cast<int*>(smem);  // [tile]
  int* s_one = s_own + tile;                  // [tile]
  int* s_start = s_one + tile;                // [tile]
  int* s_last = s_start + tile;               // [tile]
  int* s_head = s_last + tile;                // [tile]
  int* s_warp = s_head + tile;                // [2 * kWarps]
  uint4* s_x = reinterpret_cast<uint4*>(smem + ints_bytes(tile));
  uint4* s_g = s_x + static_cast<size_t>(window) * chunk;
  uint8_t* s_f =
      reinterpret_cast<uint8_t*>(s_g + static_cast<size_t>(window) * chunk);
  uint8_t* s_l = s_f + window;

  const int q = blockIdx.x % chunks;  // the chunk of vectors
  const int bt = blockIdx.x / chunks;
  const int b = bt / tiles;
  const int r0 = (bt - b * tiles) * tile;  // the tile's first row
  const int rows = min(tile, N - r0);
  const int w0 = r0 - halo;                // the window's first row
  const int v0 = q * chunk;                // the chunk's first vector
  const int cv = min(chunk, nv - v0);      // its vectors
  const I base = static_cast<I>(b) * static_cast<I>(N);  // b * N
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the vector loops: a pass takes `step` rows (or items), `cv` threads
  // each; the threads past step * cv idle
  const int step = kThreads / cv;
  const int t_row = threadIdx.x / cv;
  const int t_vec = threadIdx.x - t_row * cv;
  const bool t_on = t_row < step;

  // 1. the flag window; rows outside the sample are heads with no last.
  //    A tile with no `last` in its rows or the halo after them has no
  //    covered row: zeros, and nothing else
  bool any_last = false;
  for (int i = threadIdx.x; i < window; i += kThreads) {
    const int r = w0 + i;
    const bool in = r >= 0 && r < N;
    s_f[i] = in ? first[base + static_cast<I>(r)] : 1;
    const uint8_t l = in ? last[base + static_cast<I>(r)] : 0;
    s_l[i] = l;
    any_last |= l && i >= halo;
  }
  uint4* dxs = dx + base * static_cast<I>(nv) + v0;
  if (!__syncthreads_or(any_last)) {
    for (int i = t_row; t_on && i < rows; i += step)
      dxs[static_cast<I>(r0 + i) * static_cast<I>(nv) + t_vec] =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  // 2. x and g at the tile's rows, copied while the segments are found
  //    (in a tile with a covered row nearly every row is covered)
  const uint4* xs = x + base * static_cast<I>(nv) + v0;
  const uint4* gs = g + base * static_cast<I>(gv) + v0;
  for (int r = r0 + t_row; t_on && r < r0 + rows; r += step) {
    const int at = (r - w0) * cv + t_vec;
    copy16_async(s_x + at,
                 xs + static_cast<I>(r) * static_cast<I>(nv) + t_vec);
    copy16_async(s_g + at,
                 gs + static_cast<I>(r) * static_cast<I>(gv) + t_vec);
  }

  // 2a. each tile row's last kept row l, found as the forward finds it
  for (int i = threadIdx.x; i < tile; i += kThreads) {
    int own = -1;
    if (i < rows) {
      const int s = i + halo;  // the row's place in the window
      for (int j = s; j < s + bound; ++j) {
        if (j > s && s_f[j]) break;
        if (s_l[j]) {
          own = j + w0;
          break;
        }
      }
    }
    s_own[i] = own;
  }
  __syncthreads();

  // 2b. the items, in row order: a run of tile rows with one l. A segment
  //     of one row (h == l) goes to the list of single rows, any other to
  //     the list of walks with its first tile row, its l and its h
  int ones = 0, walks = 0;
  for (int i0 = 0; i0 < tile; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const bool start = i < rows && s_own[i] >= 0 &&
                       (i == 0 || s_own[i - 1] != s_own[i]);
    int l = 0, h = 0;
    if (start) {
      l = s_own[i];
      const int lo = max(l - halo, 0);
      h = l;
      while (h > lo && !s_f[h - w0]) --h;
    }
    const bool one = start && h == l;
    const unsigned m1 = __ballot_sync(0xffffffffu, one);
    const unsigned m2 = __ballot_sync(0xffffffffu, start && !one);
    if (lane == 0) {
      s_warp[warp] = __popc(m1);
      s_warp[kWarps + warp] = __popc(m2);
    }
    __syncthreads();
    int at1 = ones, at2 = walks, n1 = 0, n2 = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) {
        at1 += s_warp[w];
        at2 += s_warp[kWarps + w];
      }
      n1 += s_warp[w];
      n2 += s_warp[kWarps + w];
    }
    const unsigned below = (1u << lane) - 1u;
    if (one) {
      s_one[at1 + __popc(m1 & below)] = l;
    } else if (start) {
      const int k = at2 + __popc(m2 & below);
      s_start[k] = i;
      s_last[k] = l;
      s_head[k] = h;
    }
    ones += n1;
    walks += n2;
    __syncthreads();
  }

  // 3. zeros where a row is not covered: no data read
  for (int i = t_row; t_on && i < rows; i += step)
    if (s_own[i] < 0)
      dxs[static_cast<I>(r0 + i) * static_cast<I>(nv) + t_vec] =
          make_uint4(0u, 0u, 0u, 0u);
  // 4. x and g at the halo rows of the first and last segments, then wait
  //    for every copy (a block leaves none in flight)
  if (walks) {
    const int lo = s_head[0];
    const int hi = s_last[walks - 1];
    for (int r = lo + t_row; t_on && r < r0; r += step) {
      const int at = (r - w0) * cv + t_vec;
      copy16_async(s_x + at,
                   xs + static_cast<I>(r) * static_cast<I>(nv) + t_vec);
      copy16_async(s_g + at,
                   gs + static_cast<I>(r) * static_cast<I>(gv) + t_vec);
    }
    for (int r = r0 + rows + t_row; t_on && r <= hi; r += step) {
      const int at = (r - w0) * cv + t_vec;
      copy16_async(s_x + at,
                   xs + static_cast<I>(r) * static_cast<I>(nv) + t_vec);
      copy16_async(s_g + at,
                   gs + static_cast<I>(r) * static_cast<I>(gv) + t_vec);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  if (ones + walks == 0) return;
  __syncthreads();

  // 5a. a one-row segment: its max is its x (a NaN takes no part), its
  //     count 1, its sum 0 + g, so dx = g + 0 where x is not NaN, else 0:
  //     the walk's bits, with none of its work
  for (int it = t_row; t_on && it < ones; it += step) {
    const int r = s_one[it];
    const int at = (r - w0) * cv + t_vec;
    float xv[kVec], gf[kVec], out[kVec];
    V::unpack(s_x[at], xv);
    V::unpack(s_g[at], gf);
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      out[c] = xv[c] == xv[c] ? 0.f + gf[c] : 0.f;
    dxs[static_cast<I>(r) * static_cast<I>(nv) + t_vec] = V::pack(out);
  }

  // 5b. one pass over each longer segment per half vector (8 bytes: two
  //     threads share a vector, which halves the longest walk's time),
  //     from l back to h, four rows' loads issued before any is used,
  //     then dx at the item's rows in the tile. Without a tie (every count
  //     1) the quotient is the sum itself, and no division is made
  constexpr int kHalf = kVec / 2;
  const int hv = 2 * cv;  // half vectors a row
  const int w_step = kThreads / hv;
  const int w_row = threadIdx.x / hv;
  const int w_half = threadIdx.x - w_row * hv;
  const uint2* s_x2 = reinterpret_cast<const uint2*>(s_x);
  const uint2* s_g2 = reinterpret_cast<const uint2*>(s_g);
  uint2* dxs2 = reinterpret_cast<uint2*>(dxs);
  for (int it = w_row; w_row < w_step && it < walks; it += w_step) {
    const int i = s_start[it];
    const int l = s_last[it];
    const int h = s_head[it];
    float gsum[kHalf], mx[kHalf], cnt[kHalf];
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      gsum[c] = 0.f;
      mx[c] = -INFINITY;
      cnt[c] = 0.f;
    }
    for (int j = l; j >= h; j -= kRowsAhead) {
      uint2 xq[kRowsAhead], gq[kRowsAhead];
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        const int at = (max(j - u, h) - w0) * hv + w_half;
        xq[u] = s_x2[at];
        gq[u] = s_g2[at];
      }
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        if (j - u < h) break;
        float xv[kHalf], gf[kHalf];
        V::unpack_half(xq[u], xv);
        V::unpack_half(gq[u], gf);
#pragma unroll
        for (int c = 0; c < kHalf; ++c) {
          gsum[c] += gf[c];
          if (xv[c] > mx[c]) {
            mx[c] = xv[c];
            cnt[c] = 1.f;
          } else if (xv[c] == mx[c]) {
            cnt[c] += 1.f;
          }
        }
      }
    }
    bool tie = false;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) tie |= cnt[c] > 1.f;
    const int end = min(l, r0 + rows - 1);
#pragma unroll 4
    for (int r = r0 + i; r <= end; ++r) {
      float xv[kHalf], out[kHalf];
      V::unpack_half(s_x2[(r - w0) * hv + w_half], xv);
      if (tie) {
#pragma unroll
        for (int c = 0; c < kHalf; ++c)
          out[c] = xv[c] == mx[c] ? gsum[c] / fmaxf(cnt[c], 1.f) : 0.f;
      } else {
#pragma unroll
        for (int c = 0; c < kHalf; ++c)
          out[c] = xv[c] == mx[c] ? gsum[c] : 0.f;
      }
      dxs2[(static_cast<I>(r) * static_cast<I>(nv)) * 2 + w_half] =
          V::pack_half(out);
    }
  }
}

template <typename V, typename I>
int launch_as(const void* x, const void* g, const uint8_t* first,
              const uint8_t* last, void* dx, int N, int nv, int gv,
              int bound, int tile, int tiles, int chunk, int chunks,
              long long blocks, int smem, cudaStream_t stream) {
  auto kernel = seg_full_max_bwd_kernel<V, I>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(g), first,
      last, static_cast<uint4*>(dx), N, nv, gv, bound, tile, tiles, chunk,
      chunks);
  return 0;
}

template <typename V>
int launch(const void* x, const void* g, const uint8_t* first,
           const uint8_t* last, void* dx, int B, int N, int C, int gstride,
           int bound, int tile, int chunk, int smem, int wide,
           cudaStream_t stream) {
  constexpr int kVec = V::kVec;
  if (B < 0 || N < 0 || C <= 0 || C % kVec || gstride < C ||
      gstride % kVec || bound < 1 || tile < 1 || chunk < 1 ||
      2 * chunk > kThreads ||
      static_cast<long long>(smem) < smem_bytes(tile, bound, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nv = C / kVec, gv = gstride / kVec;
  if (static_cast<long long>(tile + 2ll * (bound - 1)) * chunk >
      0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * N == 0) return 0;
  const int tiles =
      static_cast<int>((static_cast<long long>(N) + tile - 1) / tile);
  const int chunks = (nv + chunk - 1) / chunk;
  const long long blocks = static_cast<long long>(B) * tiles * chunks;
  const unsigned long long vectors = static_cast<unsigned long long>(B) *
                                     static_cast<unsigned long long>(N) *
                                     static_cast<unsigned long long>(gv);
  if (blocks > 0x7fffffffll || (!wide && vectors >= (1ull << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide)
    return launch_as<V, uint64_t>(x, g, first, last, dx, N, nv, gv, bound,
                                  tile, tiles, chunk, chunks, blocks, smem,
                                  stream);
  return launch_as<V, uint32_t>(x, g, first, last, dx, N, nv, gv, bound,
                                tile, tiles, chunk, chunks, blocks, smem,
                                stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and dx (B, N, C) contiguous, C a
// multiple of 4 (f32) or 8 (bf16) (the wrapper pads the channels with
// zeros to one); g (B, N, C) with unit channel stride and rows `gstride`
// elements apart (gstride >= C, a multiple of 4 or 8, the batch stride
// N * gstride); x, g and dx 16-byte aligned; first and last (B, N)
// contiguous bytes; bound >= 1; `tile` rows and `chunk` 16-byte vectors of
// them a block, `smem` bytes of dynamic shared memory, at least
// smem_bytes(tile, bound, chunk) (the wrapper's seg_max_bwd_plan). wide: 1
// takes 64-bit row offsets, 0 32-bit ones, refused from 2**31 vectors of
// g's rows (the widest operand) on. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for what it does not take.
extern "C" int seg_full_max_bwd(const void* x, const void* g,
                                const void* first, const void* last, void* dx,
                                int B, int N, int C, int gstride, int bound,
                                int tile, int chunk, int smem, int dtype,
                                int wide, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(first);
  const uint8_t* l = static_cast<const uint8_t*>(last);
  int err;
  if (dtype == 0) {
    err = launch<F32x4>(x, g, f, l, dx, B, N, C, gstride, bound, tile, chunk,
                        smem, wide, st);
  } else if (dtype == 1) {
    err = launch<Bf16x8>(x, g, f, l, dx, B, N, C, gstride, bound, tile,
                         chunk, smem, wide, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
