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
// percent of the candidates' pairs do, and a centre distance beyond the sum
// of the circumscribed radii settles the rest at 0 in a few operations; every
// pair writes 4 bytes, 3.2 MB per sample at 900 x 900. This kernel clips
// every pair all the same. There is no matrix product to give the tensor
// cores.
//
// Design: one thread per pair. A block is a 32 (j) x 8 (i) tile; a warp
// runs along j, so the output is written in 128-byte rows. The block stages
// its 32 B-boxes (centre and the four corner offsets, from one sincosf each)
// and its 8 A-boxes (the four corner offsets) in shared memory; each thread
// reads its A corners once. The polygon lives in registers: every array
// index below is a compile-time constant after full unrolling, and "append
// at cnt" is the TPU kernel's 8 predicated selects, so nothing is indexed
// dynamically and the polygon does not spill. -Xptxas -v reports a 32-byte
// stack frame and 0 spill bytes: the frame is sincosf's range reduction for
// large arguments, run only by the threads that load a tile's boxes. The
// ragged edge is masked; no padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileJ = 32;
constexpr int kTileI = 8;
constexpr int kMaxV = 8;
constexpr float kEps = 1e-8f;
constexpr float kInsideEps = 1e-6f;

// the 4 CCW corners of a box relative to its centre: corner k is
// (w * sx[k], l * sy[k]) rotated by yaw
__device__ __forceinline__ void corner_offsets(float w, float l, float yaw,
                                               float* ox, float* oy) {
  float s, c;
  sincosf(yaw, &s, &c);
  const float sx[4] = {0.5f, -0.5f, -0.5f, 0.5f};
  const float sy[4] = {0.5f, 0.5f, -0.5f, -0.5f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float x = w * sx[k];
    const float y = l * sy[k];
    ox[k] = c * x - s * y;
    oy[k] = s * x + c * y;
  }
}

__global__ void __launch_bounds__(kTileJ* kTileI)
rotated_iou_intersect_kernel(const float* __restrict__ boxes1,
                             const float* __restrict__ boxes2,
                             float* __restrict__ out, int N, int M) {
  // B tile: centre (x, y) and 4 corner offsets (x, y); A tile: offsets
  __shared__ float sb[kTileJ][10];
  __shared__ float sa[kTileI][10];
  const int b = blockIdx.z;
  const int tj = threadIdx.x;
  const int ti = threadIdx.y;
  const int j0 = blockIdx.x * kTileJ;
  const int i0 = blockIdx.y * kTileI;
  if (ti == 0 && j0 + tj < M) {
    const float* p = boxes2 + (static_cast<size_t>(b) * M + j0 + tj) * 5;
    float ox[4], oy[4];
    corner_offsets(p[2], p[3], p[4], ox, oy);
    sb[tj][0] = p[0];
    sb[tj][1] = p[1];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sb[tj][2 + 2 * k] = ox[k];
      sb[tj][3 + 2 * k] = oy[k];
    }
  } else if (ti == 1 && tj < kTileI && i0 + tj < N) {
    const float* p = boxes1 + (static_cast<size_t>(b) * N + i0 + tj) * 5;
    float ox[4], oy[4];
    corner_offsets(p[2], p[3], p[4], ox, oy);
    sa[tj][0] = p[0];
    sa[tj][1] = p[1];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sa[tj][2 + 2 * k] = ox[k];
      sa[tj][3 + 2 * k] = oy[k];
    }
  }
  __syncthreads();
  const int i = i0 + ti;
  const int j = j0 + tj;
  if (i >= N || j >= M) return;

  // B's corners relative to A's centre
  const float rel_x = sb[tj][0] - sa[ti][0];
  const float rel_y = sb[tj][1] - sa[ti][1];
  float bx[4], by[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bx[k] = rel_x + sb[tj][2 + 2 * k];
    by[k] = rel_y + sb[tj][3 + 2 * k];
  }

  float px[kMaxV], py[kMaxV];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = sa[ti][2 + 2 * k];
    py[k] = sa[ti][3 + 2 * k];
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
  out[(static_cast<size_t>(b) * N + i) * M + j] = cnt >= 3 ? area : 0.f;
}

}  // namespace

// boxes1 (B, N, 5), boxes2 (B, M, 5), out (B, N, M): contiguous f32. The
// caller guarantees B <= 65535 and B*N*M < 2**31. Returns cudaGetLastError()
// after the launch.
extern "C" int rotated_iou_intersect(const float* boxes1, const float* boxes2,
                                     float* out, int B, int N, int M,
                                     void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kTileJ, kTileI);
  const dim3 grid((M + kTileJ - 1) / kTileJ, (N + kTileI - 1) / kTileI, B);
  rotated_iou_intersect_kernel<<<grid, block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      boxes1, boxes2, out, N, M);
  return static_cast<int>(cudaGetLastError());
}
