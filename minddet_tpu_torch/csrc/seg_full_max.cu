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
// head (the voxelizer's per-pillar point cap). A row r is covered where its
// segment's last kept row l is the nearest `last` at or after r, fewer than
// `bound` rows away, with no segment head in (r, l]; h is the nearest head
// at or before l, but at most `bound` - 1 rows back, and
//
//   out[b, r, :] = max over rows j in [h, l] of x[b, j, :]
//
// taken from l back to h. Every other row (past its segment's last row, in
// a segment with no last row, on the invalid tail) is 0. Only max and
// select touch the values, so bf16 stays exact. NaNs are not propagated
// (fmaxf, __hmax2); the order fixes the sign of a zero max.
//
// What bounds it on an H100: memory. The least it must move is x at the
// covered rows (the others' out is 0 and needs no read), out at every row
// and the two flag planes; the arithmetic is one max per value read. On a
// nuScenes-sized voxelizer stream about 31 % of the rows are covered
// (`first_come` puts the kept pillars first, then the dropped ones and the
// invalid tail), most segments hold one row; on the Waymo-like frames about
// 60 %, in pillars filled toward the cap near the lidar. The TPU kernel's
// VMEM halo windows, 32-bit sublane rotates and shift levels have no
// counterpart here.
//
// Design (K5b's tiles, csrc/seg_full_max_bwd.cu, with a max for its sums):
// a block of 128 threads owns a tile of `tile` rows of one sample and
// `chunk` 16-byte vectors of each row (the wrapper's plan, ops/seg_max.py:
// seg_max_plan: a whole row of C = 32, 64 rows in f32, 128 in bf16).
//  1. It reads the flags of the tile and of `bound` - 1 rows of halo on
//     each side, each byte once per block, into two bit masks in shared
//     memory (a ballot a warp). A segment holds at most `bound` rows, so
//     the window sees whole every segment that covers a row of the tile. A
//     tile with no `last` in its rows or the halo after them has no covered
//     row: it writes zeros with 16-byte stores and reads no x.
//  2. Otherwise it starts cp.async copies of x at its rows into shared
//     memory, and while they fly one thread a row finds from the masks, with
//     a few word operations and no walk, the row's l (or "not covered"),
//     whether the row starts a run of rows with one l, and the run's h.
//     A ballot and a prefix over the warps list the runs of more than one
//     row in row order and mark each row with its run's index (a one-row
//     segment, h == l, is marked as such). Warp 0 copies the rows before
//     the tile of the segment that covers its first row, warp 1 the rows
//     after it of the segment that covers its last row: no other segment
//     reaches past the tile.
//  3. Rows that are not covered get zeros, with no x read.
//  4. The block waits for every copy. A longer run's segment is walked once
//     per vector, from l back to h, four rows' loads ahead (the flags are
//     known, so no load waits on a test), and its max kept in shared
//     memory. Then every covered row is written once, in row order: a
//     one-row segment's x (a copy, no walk) or its run's max. A segment
//     costs O(L) reads, not the O(L^2) of one walk per row, and each x
//     value of a covered row is read from device memory once per block;
//     rows of a segment in the halo are read here and written by the
//     neighbouring tile.
// The max runs in the order of the per-row kernel this one replaced (one
// thread per output vector, each walking its row's segment from l back to
// h), so out is bit for bit that kernel's, NaNs and signed zeros included.
// No atomics. Row offsets are 32-bit below 2**31 vectors of x and 64-bit
// from there on (`wide`); the window's and the tile's indices are 32-bit.
//
// Measured (scripts/seg_max_fwd_turns.py against the per-row kernel, in
// turns; H100 80GB HBM3, 700 W): see PERF.md, K5f. Reading x straight from
// device memory where it is used, in place of the cp.async copies, was
// 8-41 % slower on every stream; at batch 1 a block's time goes to its two
// round trips (flags, then x) and to the shared-memory steps between them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 10;  // blocks an SM holds: at most 48 registers
constexpr int kRowsAhead = 4;   // rows of a walk (or of a thread) read ahead
constexpr int kFlagRounds = 2;  // rounds of flag loads in flight
constexpr int kDefaultSmem = 48 * 1024;

struct F32x4 {
  static __device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
    return make_uint4(
        __float_as_uint(fmaxf(__uint_as_float(a.x), __uint_as_float(b.x))),
        __float_as_uint(fmaxf(__uint_as_float(a.y), __uint_as_float(b.y))),
        __float_as_uint(fmaxf(__uint_as_float(a.z), __uint_as_float(b.z))),
        __float_as_uint(fmaxf(__uint_as_float(a.w), __uint_as_float(b.w))));
  }
};

struct Bf16x8 {
  static __device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
    uint4 r;
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
    __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = __hmax2(pa[i], pb[i]);
    return r;
  }
};

// shared memory of a block: per tile row its item (-1: not covered, -2: a
// one-row segment, else its longer segment's index); per longer segment its
// l and its h; the warps' counts of them and the halo's two edges (16-byte
// aligned after them); x at the window's rows and the longer segments'
// maxima, `chunk` vectors each; the two flag planes of the window as bit
// masks, 32 rows a word, and one word more
__host__ __device__ constexpr long long ints_bytes(int tile) {
  return (12ll * tile + 4ll * kWarps + 8 + 15) / 16 * 16;
}
__host__ __device__ constexpr long long flag_words(long long window) {
  return kWarps * ((window + kThreads - 1) / kThreads) + 1;
}
__host__ __device__ constexpr long long smem_bytes(int tile, int bound,
                                                   int chunk) {
  return ints_bytes(tile) + (2ll * tile + 2ll * (bound - 1)) * 16ll * chunk +
         8 * flag_words(tile + 2ll * (bound - 1));
}

__device__ __forceinline__ void copy16_async(uint4* dst, const uint4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// the bits of window rows [p, p + 32) of a flag plane
__device__ __forceinline__ unsigned bits_at(const unsigned* plane, int p) {
  const int w = p >> 5, o = p & 31;
  return o ? (plane[w] >> o) | (plane[w + 1] << (32 - o)) : plane[w];
}

// bits [a, z] of a word, 0 <= a <= z <= 31
__device__ __forceinline__ unsigned bit_range(int a, int z) {
  return (z == 31 ? ~0u : (2u << z) - 1u) & ~((1u << a) - 1u);
}

// x, out: rows of nv 16-byte vectors; a block takes `chunk` of a row's
// vectors (the last chunk may hold fewer)
template <typename V, typename I>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seg_full_max_kernel(const uint4* __restrict__ x,
                    const uint8_t* __restrict__ first,
                    const uint8_t* __restrict__ last,
                    uint4* __restrict__ out, int N, int nv, int bound,
                    int tile, int tiles, int chunk, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = bound - 1;
  const int window = tile + 2 * halo;
  int* s_own = reinterpret_cast<int*>(smem);  // [tile]
  int* s_last = s_own + tile;                 // [tile]
  int* s_head = s_last + tile;                // [tile]
  int* s_warp = s_head + tile;                // [kWarps]
  int* s_edge = s_warp + kWarps;              // [2]
  uint4* s_x = reinterpret_cast<uint4*>(smem + ints_bytes(tile));
  uint4* s_m = s_x + static_cast<size_t>(window) * chunk;  // [tile * chunk]
  const int words = static_cast<int>(flag_words(window));
  unsigned* s_fb =
      reinterpret_cast<unsigned*>(s_m + static_cast<size_t>(tile) * chunk);
  unsigned* s_lb = s_fb + words;

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

  // 1. the flag window, as bit masks (a ballot a warp); rows outside the
  //    sample or past the window are heads with no last. The loads of
  //    kFlagRounds rounds of kThreads rows are issued before any is used,
  //    so that a tile of 128 rows and its halo cost one round trip. A tile
  //    with no `last` in its rows or the halo after them has no covered
  //    row: zeros, and nothing else
  bool any_last = false;
  for (int i00 = 0; i00 < window; i00 += kFlagRounds * kThreads) {
    bool fv[kFlagRounds], lv[kFlagRounds];
#pragma unroll
    for (int u = 0; u < kFlagRounds; ++u) {
      const int i = i00 + u * kThreads + threadIdx.x;
      const int r = w0 + i;
      const bool in = i < window && r >= 0 && r < N;
      fv[u] = !in || first[base + static_cast<I>(r)];
      lv[u] = in && last[base + static_cast<I>(r)];
    }
#pragma unroll
    for (int u = 0; u < kFlagRounds; ++u) {
      const int i0 = i00 + u * kThreads;
      if (i0 < window) {
        const unsigned fw = __ballot_sync(0xffffffffu, fv[u]);
        const unsigned lw = __ballot_sync(0xffffffffu, lv[u]);
        if (lane == 0) {
          s_fb[(i0 >> 5) + warp] = fw;
          s_lb[(i0 >> 5) + warp] = lw;
        }
        any_last |= lv[u] && i0 + static_cast<int>(threadIdx.x) >= halo;
      }
    }
  }
  if (threadIdx.x == 0) {
    s_fb[words - 1] = ~0u;
    s_lb[words - 1] = 0u;
  }
  uint4* outs = out + base * static_cast<I>(nv) + v0;
  if (!__syncthreads_or(any_last)) {
    for (int i = t_row; t_on && i < rows; i += step)
      outs[static_cast<I>(r0 + i) * static_cast<I>(nv) + t_vec] =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  // 2. x at the tile's rows, copied while the segments are found (in a tile
  //    with a covered row nearly every row is covered)
  const uint4* xs = x + base * static_cast<I>(nv) + v0;
  auto copy_row = [&](int r, int v) {
    copy16_async(s_x + (r - w0) * cv + v,
                 xs + static_cast<I>(r) * static_cast<I>(nv) + v);
  };
  for (int r = r0 + t_row; t_on && r < r0 + rows; r += step)
    copy_row(r, t_vec);

  // 2a. the items, in row order: a run of tile rows with one l. One thread
  //     a row finds the row's l from the bit masks (the nearest `last` at or
  //     after it, fewer than `bound` rows on, before any head after it) and
  //     whether the row starts a run: the first tile row, or a row whose
  //     row before has its own last, is a segment's head or lies `bound`
  //     rows or more from l. A run's h is the nearest head at or before its
  //     first row, and at least l - halo (no head lies between that row and
  //     l). A segment of one row (h == l) is marked at its row, any other
  //     goes to the list of walks with its l and its h, by a ballot and a
  //     prefix over the warps, and its rows are marked with its index in
  //     the list. After the first round's counts, warp 0 copies x at the
  //     rows before the tile of the segment that covers its first row, from
  //     its h; warp 1, after the round that holds the tile's last row, the
  //     rows after the tile up to that row's l. No other segment reaches
  //     past the tile: the l of the rows rises with the row, and so does h
  int walks = 0;
  for (int i0 = 0; i0 < tile; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    int own = -1, h = 0;
    bool start = false;
    if (i < rows) {
      const int s = i + halo;  // the row's place in the window
      for (int k = 0; k < bound; k += 32) {
        const int n = min(32, bound - k);
        const unsigned m = n == 32 ? ~0u : (1u << n) - 1u;
        const unsigned lw = bits_at(s_lb, s + k) & m;
        const unsigned fw = bits_at(s_fb, s + k) & m & (k ? ~0u : ~1u);
        const unsigned hit = lw & (fw ? (fw & (0u - fw)) - 1u : ~0u);
        if (hit) {
          own = w0 + s + k + __ffs(hit) - 1;
          break;
        }
        if (fw) break;
      }
      if (own >= 0)
        start = i == 0 || ((s_lb[(s - 1) >> 5] >> ((s - 1) & 31)) & 1u) ||
                ((s_fb[s >> 5] >> (s & 31)) & 1u) ||
                own - (r0 + i - 1) > halo;
      if (start) {
        const int lo = max(own - halo, 0);
        h = lo;
        const int plo = lo - w0 + 1;  // window rows [plo, s] may hold h
        for (int top = s; top >= plo; top -= 32) {
          const int p = max(top - 31, 0);
          const unsigned fw = bits_at(s_fb, p) &
                              bit_range(max(plo, top - 31) - p, top - p);
          if (fw) {
            h = w0 + p + 31 - __clz(fw);
            break;
          }
        }
      }
    }
    const bool one = start && h == own;
    if (i == 0) s_edge[0] = own >= 0 ? h : r0;
    if (i == rows - 1) s_edge[1] = own;
    const unsigned m2 = __ballot_sync(0xffffffffu, start && !one);
    if (lane == 0) s_warp[warp] = __popc(m2);
    __syncthreads();
    if (i0 == 0 && warp == 0) {
      const int h0 = s_edge[0];
      for (int k = lane; k < (r0 - h0) * cv; k += 32)
        copy_row(h0 + k / cv, k % cv);
    }
    if (i0 <= rows - 1 && rows - 1 < i0 + kThreads && warp == 1) {
      const int n_after = s_edge[1] - (r0 + rows - 1);
      for (int k = lane; k < n_after * cv; k += 32)
        copy_row(r0 + rows + k / cv, k % cv);
    }
    int at = walks, n2 = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) at += s_warp[w];
      n2 += s_warp[w];
    }
    // a row's walk: the last walk that starts at or before it
    const int k = at + __popc(m2 & (lane == 31 ? ~0u : (2u << lane) - 1u)) - 1;
    if (i < tile) s_own[i] = own < 0 ? -1 : one ? -2 : k;
    if (start && !one) {
      s_last[k] = own;
      s_head[k] = h;
    }
    walks += n2;
    __syncthreads();
  }

  // 3. zeros where a row is not covered: no x read
  for (int i = t_row; t_on && i < rows; i += step)
    if (s_own[i] == -1)
      outs[static_cast<I>(r0 + i) * static_cast<I>(nv) + t_vec] =
          make_uint4(0u, 0u, 0u, 0u);
  // 4. wait for every copy (a block leaves none in flight)
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // 4a. one pass over each longer segment per vector, from l back to h,
  //     four rows' loads issued before any is used, its max kept in shared
  //     memory
  for (int it = t_row; t_on && it < walks; it += step) {
    const int l = s_last[it];
    const int h = s_head[it];
    uint4 m = s_x[(l - w0) * cv + t_vec];
    for (int j = l - 1; j >= h; j -= kRowsAhead) {
      uint4 xq[kRowsAhead];
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u)
        xq[u] = s_x[(max(j - u, h) - w0) * cv + t_vec];
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        if (j - u < h) break;
        m = V::vmax(m, xq[u]);
      }
    }
    s_m[it * cv + t_vec] = m;
  }
  __syncthreads();

  // 4b. every covered row: a one-row segment's x, bits and all, or its
  //     longer segment's max; kRowsAhead rows a thread read before any is
  //     written
  for (int i0 = t_row; t_on && i0 < rows; i0 += kRowsAhead * step) {
    int k[kRowsAhead];
    uint4 v[kRowsAhead];
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {
      const int i = i0 + u * step;
      k[u] = i < rows ? s_own[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {
      const int i = i0 + u * step;
      if (k[u] == -2)
        v[u] = s_x[(i + halo) * cv + t_vec];
      else if (k[u] >= 0)
        v[u] = s_m[k[u] * cv + t_vec];
    }
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u)
      if (k[u] != -1)
        outs[static_cast<I>(r0 + i0 + u * step) * static_cast<I>(nv) +
             t_vec] = v[u];
  }
}

template <typename V, typename I>
int launch_as(const void* x, const uint8_t* first, const uint8_t* last,
              void* out, int N, int nv, int bound, int tile, int tiles,
              int chunk, int chunks, long long blocks, int smem,
              cudaStream_t stream) {
  auto kernel = seg_full_max_kernel<V, I>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const uint4*>(x), first, last, static_cast<uint4*>(out), N,
      nv, bound, tile, tiles, chunk, chunks);
  return 0;
}

template <int kVec, typename V>
int launch(const void* x, const uint8_t* first, const uint8_t* last,
           void* out, int B, int N, int C, int bound, int tile, int chunk,
           int smem, int wide, cudaStream_t stream) {
  if (B < 0 || N < 0 || C <= 0 || C % kVec || bound < 1 || tile < 1 ||
      chunk < 1 || chunk > kThreads ||
      static_cast<long long>(smem) < smem_bytes(tile, bound, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nv = C / kVec;
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
                                     static_cast<unsigned long long>(nv);
  if (blocks > 0x7fffffffll || (!wide && vectors >= (1ull << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide)
    return launch_as<V, uint64_t>(x, first, last, out, N, nv, bound, tile,
                                  tiles, chunk, chunks, blocks, smem, stream);
  return launch_as<V, uint32_t>(x, first, last, out, N, nv, bound, tile,
                                tiles, chunk, chunks, blocks, smem, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and out (B, N, C) contiguous and
// 16-byte aligned, C a multiple of 4 (f32) or 8 (bf16) (the wrapper pads
// the channels with zeros to one); first and last (B, N) contiguous bytes;
// bound >= 1; `tile` rows and `chunk` 16-byte vectors of them a block,
// `smem` bytes of dynamic shared memory, at least smem_bytes(tile, bound,
// chunk) (the wrapper's seg_max_plan). wide: 1 takes 64-bit row offsets, 0
// 32-bit ones, refused from 2**31 vectors of x on. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what it
// does not take.
extern "C" int seg_full_max(const void* x, const void* first,
                            const void* last, void* out, int B, int N, int C,
                            int bound, int tile, int chunk, int smem,
                            int dtype, int wide, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(first);
  const uint8_t* l = static_cast<const uint8_t*>(last);
  int err;
  if (dtype == 0) {
    err = launch<4, F32x4>(x, f, l, out, B, N, C, bound, tile, chunk, smem,
                           wide, st);
  } else if (dtype == 1) {
    err = launch<8, Bf16x8>(x, f, l, out, B, N, C, bound, tile, chunk, smem,
                            wide, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
