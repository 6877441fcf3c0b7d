// Rotated-box BEV intersection areas: the rotated NMS's pairwise matrix.
//
// Replaces minddet_tpu/ops/rotated_iou_pallas.py:55 _intersect_kernel
// (reached through rotated_intersection_bev_pallas <- rotated_intersection_bev
// <- rotated_iou_bev <- ops/nms.py:rotated_nms).
//
//   out[b, i, j] = area(rect boxes1[b, i] ∩ rect boxes2[b, j])
//
// boxes are [x, y, w, l, yaw] f32, (B, N, 5) and (B, M, 5); out is (B, N, M)
// f32. The algorithm is the TPU kernel's: Sutherland-Hodgman clips quad A
// (boxes1[i]) against the four half-planes of quad B (boxes2[j]) into an
// 8-slot polygon (a rect ∩ rect has at most 8 vertices), a vertex counts as
// inside at side >= -1e-6, the clip-line parameter divides by 1 where
// |den| < 1e-8, and the area is the shoelace sum over the slots in use.
// Coordinates are pair-relative (A's centre at the origin), as in the plain
// version ops/rotated_iou.py:rotated_intersection_bev_plain, so rounding
// scales with the boxes' size and not with their distance from the sensor.
//
// What bounds it on an H100: on the NMS's candidates, the bytes of the
// output. A pair that overlaps costs ~1.3e3 f32 operations of predicated
// polygon arithmetic (see OPS_PER_PAIR in chip_smoke.py), but only a few
// percent of the candidates' pairs come near each other: every pair writes
// 4 bytes, 3.2 MB per sample at 900 x 900. There is no matrix product to
// give the tensor cores.
//
// Design: a separation test settles most pairs, and a per-block queue
// gives the clip only to the rest, at full warps.
// - The test (ops/rotated_iou.py:separated, its plain mirror): a pair whose
//   centres lie farther apart than (r_a + r_b') (1 + 1e-5) is disjoint,
//   with r = hypot(w, l) / 2 the circumscribed radius and r_b' = r_b +
//   2e-6 / min(|w_b|, |l_b|) covering the clip's inside tolerance (it keeps
//   vertices up to 1e-6 / |edge| outside an edge of B); the 1e-5 covers the
//   f32 rounding of the corners and of the test. Its area is exactly 0 and
//   is written after ~7 operations. A B with a zero edge gets r_b' = inf
//   and is never settled: its edges clip nothing, so the clip returns A's
//   area, as the plain version does. NaN and infinite distances go to the
//   clip too.
// - A block takes a TI (i) x 64 (j) tile of pairs with 256 threads. It
//   stages the tile's TI A and 64 B boxes in shared memory (centre, radius
//   and the four corner offsets, from one sincosf per box). Each thread
//   tests TI / 4 pairs, a warp 32 consecutive j of one row, so the zeros go
//   out in 128-byte rows. Pairs the test does not settle are appended to a
//   shared queue of tile indices (16 bits each), one native shared int
//   atomicAdd per warp (__ballot_sync, __popc). The queue holds the whole
//   tile, so it never overflows.
// - TI comes from the wrapper (ops/rotated_iou.py:tile_rows): 64, or the
//   largest of 32, 16, 8 that still gives every SM a block. A small call
//   (the train step's 8 x 128 x 64 pairs, 29 % clipped) then spreads its
//   clips over the card instead of queueing ~1,200 per block on 16 SMs.
// - Then the block drains the queue one pair per thread, every warp on 32
//   queued pairs: candidates are ordered by score, not by place, so at 3 %
//   survivors ~62 % of 32-pair warps of the output hold one, and an
//   early-out per thread would leave those warps running the whole clip.
//   The clip is the TPU kernel's arithmetic: the polygon lives in
//   registers, every array index is a compile-time constant after full
//   unrolling, and "append at cnt" is 8 predicated selects, so nothing is
//   indexed dynamically and the polygon does not spill.
// The ragged edge is masked; no padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // the tile's j extent and largest i extent
constexpr int kThreads = 256;
constexpr int kMaxV = 8;
constexpr float kEps = 1e-8f;
constexpr float kInsideEps = 1e-6f;
constexpr float kSepRel = 1e-5f;  // ops/rotated_iou.py:SEP_REL

// a staged box: centre, radius (B's grown by the inside tolerance), and
// the 4 CCW corner offsets
struct Box {
  float x, y, r;
  float ox[4], oy[4];
};

// corner k is (w * sx[k], l * sy[k]) rotated by yaw
__device__ __forceinline__ void stage(const float* p, bool grow, Box* box) {
  float s, c;
  sincosf(p[4], &s, &c);
  const float sx[4] = {0.5f, -0.5f, -0.5f, 0.5f};
  const float sy[4] = {0.5f, 0.5f, -0.5f, -0.5f};
  box->x = p[0];
  box->y = p[1];
  box->r = 0.5f * hypotf(p[2], p[3]);
  if (grow) box->r += 2.f * kInsideEps / fminf(fabsf(p[2]), fabsf(p[3]));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float x = p[2] * sx[k];
    const float y = p[3] * sy[k];
    box->ox[k] = c * x - s * y;
    box->oy[k] = s * x + c * y;
  }
}

// area(A ∩ B) by the TPU kernel's clip, in A-relative coordinates
__device__ __forceinline__ float clip_area(const Box& A, const Box& B) {
  const float rel_x = B.x - A.x;
  const float rel_y = B.y - A.y;
  float bx[4], by[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bx[k] = rel_x + B.ox[k];
    by[k] = rel_y + B.oy[k];
  }

  float px[kMaxV], py[kMaxV];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = A.ox[k];
    py[k] = A.oy[k];
    px[k + 4] = 0.f;
    py[k + 4] = 0.f;
  }
  int cnt = 4;

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float ex0 = bx[e];
    const float ey0 = by[e];
    const float dx = bx[(e + 1) % 4] - ex0;
    const float dy = by[(e + 1) % 4] - ey0;
    float side[kMaxV];
#pragma unroll
    for (int k = 0; k < kMaxV; ++k)
      side[k] = dx * (py[k] - ey0) - dy * (px[k] - ex0);
    float nx[kMaxV], ny[kMaxV];
#pragma unroll
    for (int k = 0; k < kMaxV; ++k) {
      nx[k] = 0.f;
      ny[k] = 0.f;
    }
    int ncnt = 0;
#pragma unroll
    for (int k = 0; k < kMaxV; ++k) {
      const int kn = (k + 1) % kMaxV;
      const bool active = cnt > k;
      const bool wrap = cnt == k + 1;
      const float qx = px[k];
      const float qy = py[k];
      const float rx = wrap ? px[0] : px[kn];
      const float ry = wrap ? py[0] : py[kn];
      const float s_cur = side[k];
      const float s_nxt = wrap ? side[0] : side[kn];
      const bool in_cur = s_cur >= -kInsideEps;
      const bool in_nxt = s_nxt >= -kInsideEps;
      const float den = s_cur - s_nxt;
      const float t = s_cur / (fabsf(den) < kEps ? 1.f : den);
      const float ix = qx + t * (rx - qx);
      const float iy = qy + t * (ry - qy);

      const bool emit_cur = active && in_cur;
#pragma unroll
      for (int s = 0; s < kMaxV; ++s) {
        const bool hit = emit_cur && ncnt == s;
        nx[s] = hit ? qx : nx[s];
        ny[s] = hit ? qy : ny[s];
      }
      ncnt += emit_cur ? 1 : 0;
      const bool emit_x = active && (in_cur != in_nxt);
#pragma unroll
      for (int s = 0; s < kMaxV; ++s) {
        const bool hit = emit_x && ncnt == s;
        nx[s] = hit ? ix : nx[s];
        ny[s] = hit ? iy : ny[s];
      }
      ncnt += emit_x ? 1 : 0;
    }
#pragma unroll
    for (int k = 0; k < kMaxV; ++k) {
      px[k] = nx[k];
      py[k] = ny[k];
    }
    cnt = ncnt;
  }

  float area = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxV; ++k) {
    const int kn = (k + 1) % kMaxV;
    const bool wrap = cnt == k + 1;
    const float rx = wrap ? px[0] : px[kn];
    const float ry = wrap ? py[0] : py[kn];
    area += cnt > k ? px[k] * ry - rx * py[k] : 0.f;
  }
  area = fmaxf(0.5f * area, 0.f);
  return cnt >= 3 ? area : 0.f;
}

__global__ void __launch_bounds__(kThreads)
rotated_iou_intersect_kernel(const float* __restrict__ boxes1,
                             const float* __restrict__ boxes2,
                             float* __restrict__ out, int N, int M, int TI) {
  __shared__ Box sa[kTile], sb[kTile];
  __shared__ unsigned short queue[kTile * kTile];
  __shared__ int s_count;
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * kTile;
  const int i0 = blockIdx.y * TI;
  const int t = threadIdx.x;
  if (t == 0) s_count = 0;
  if (t < TI && i0 + t < N) {
    stage(boxes1 + (static_cast<size_t>(b) * N + i0 + t) * 5, false, &sa[t]);
  } else if (t >= kTile && t < 2 * kTile && j0 + t - kTile < M) {
    stage(boxes2 + (static_cast<size_t>(b) * M + j0 + t - kTile) * 5, true,
          &sb[t - kTile]);
  }
  __syncthreads();

  // the test: a warp takes 32 consecutive j of one row i per step
  float* row0 = out + (static_cast<size_t>(b) * N + i0) * M + j0;
  const int lane = t & 31;
  for (int q = t; q < TI * kTile; q += kThreads) {
    const int il = q / kTile;
    const int jl = q % kTile;
    bool clip = false;
    if (i0 + il < N && j0 + jl < M) {
      const float dx = sb[jl].x - sa[il].x;
      const float dy = sb[jl].y - sa[il].y;
      const float d2 = dx * dx + dy * dy;
      const float reach = (sa[il].r + sb[jl].r) * (1.f + kSepRel);
      if (d2 > reach * reach && isfinite(d2)) {
        row0[static_cast<size_t>(il) * M + jl] = 0.f;
      } else {
        clip = true;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, clip);
    if (ballot != 0u) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&s_count, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (clip) {
        queue[base + __popc(ballot & ((1u << lane) - 1u))] =
            static_cast<unsigned short>(q);
      }
    }
  }
  __syncthreads();

  // the drain: one queued pair per thread
  const int count = s_count;
  for (int k = t; k < count; k += kThreads) {
    const int q = queue[k];
    const int il = q / kTile;
    const int jl = q % kTile;
    row0[static_cast<size_t>(il) * M + jl] = clip_area(sa[il], sb[jl]);
  }
}

}  // namespace

// boxes1 (B, N, 5), boxes2 (B, M, 5), out (B, N, M): contiguous f32;
// tile_rows (TI) a multiple of 8 in [8, 64]. The caller guarantees B <=
// 65535 and B*N*M < 2**31. Returns cudaGetLastError() after the launch.
extern "C" int rotated_iou_intersect(const float* boxes1, const float* boxes2,
                                     float* out, int B, int N, int M,
                                     int tile_rows, void* stream) {
  if (tile_rows < 8 || tile_rows > kTile || tile_rows % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || N <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((M + kTile - 1) / kTile, (N + tile_rows - 1) / tile_rows, B);
  rotated_iou_intersect_kernel<<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      boxes1, boxes2, out, N, M, tile_rows);
  return static_cast<int>(cudaGetLastError());
}
