// Inverse-affine bilinear warp ("warp affine"), forward.
//
// Replaces minddet_tpu/ops/bilinear.py:49 _fwd_kernel as reached through
// minddet_tpu/data/transforms.py:130 warp_images (the input warps of the
// COCO train transform, the mosaic, the GT bitmaps and both COCO
// evaluations). The row gather (csrc/bilinear_gather.cu) stays the port of
// that kernel for ROIAlign and the BEV second stage, whose points are no
// affine grid.
//
//   out[b, y, x, :] = sum over the 4 corners c of w_c * x[b, corner_c, :],
//   (xs, ys) = A_b . (x, y, 1)
//
// x is (B, H, W, C) NHWC in f32 or bf16, any C >= 1, read unpadded; the
// affines are (B, 2, 3) f32 (output pixel -> input pixel); out is
// (B, OH, OW, C) in x's type. A corner off the map adds nothing; a corner
// on the map is read even where its weight is 0, so NaN and inf propagate
// as in the row gather. The sum is taken in f32 and rounded once.
//
// The arithmetic is the row gather's route step by step, so the two agree
// bit for bit on maps of fewer than 2**24 pixels: the coordinates as
// data/transforms.py:affine_points orders them (a00 * x, a01 * y, their
// sum, then + a02), the corners and weights as ops/bilinear.py:
// bilinear_corners does (floor, d = v - floor, (1 - dy)(1 - dx),
// (1 - dy) dx, dy (1 - dx), dy dx; the in-map tests in float), every step
// written with __fmul_rn / __fadd_rn / __fsub_rn so that nothing is
// contracted into an FMA, and the corners accumulated in the row gather's
// order, fmaf(w_c, v_c, acc) for c = 0..3.
//
// What bounds it on an H100: memory. It writes B*OH*OW*C*elt bytes and
// reads the map rows its corners touch, plus 24 bytes of affine per image;
// the arithmetic is ~28 f32 operations per pixel and 4 FMAs per value. The
// TPU kernel multiplies a one-hot selection matrix built from precomputed
// corners with the resident map; here the corners are six multiply-adds
// of the image's 2x3 matrix, so no corners tensor exists.
//
// Design. Two routes, chosen by C (warp_affine_plan in ops/bilinear.py
// mirrors the choice):
// - The pixel route, C <= 4 (f32) or <= 8 (bf16), one 16-byte vector a
//   pixel at most: a block of 256 threads owns a 32 x 8 tile of one
//   image's output, one pixel a thread, so a warp reads neighbouring map
//   pixels and the warps of a block share map rows in L1. A pixel with no
//   corner on the map reads nothing (most of a mosaic quadrant's warp);
//   else it issues all its corners' loads at once, an off-map corner's at
//   a clamped place, and adds those on the map. Each thread stores its
//   pixel's C values. Staging each tile's source window in shared memory
//   with cp.async (the rounded coordinates stay monotone, so the tile
//   corners' bounding box grown by one pixel holds it) was slower on an
//   H100 at every COCO warp, as was staging the output tile for 16-byte
//   stores (PERF.md, section 6): a block waits for its whole window before
//   it computes.
// - The vector route, wider C (the GT bitmaps' 128 slots): one thread a
//   16-byte vector of a pixel (4 f32 or 8 bf16 channels), the vectors of a
//   pixel on neighbouring threads, as in the row gather; each thread maps
//   its pixel itself. Where C is not a whole number of vectors the pixel
//   rows are not 16-byte aligned and every value moves on its own, the
//   last vector of a pixel covering the tail.
// Thread indices are 32-bit (the plan refuses an image of 2**31 vectors);
// every offset into x and out is 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 32;  // pixel route: output columns a block owns
constexpr int kTileH = 8;   // and rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Affine {
  float a00, a01, a02, a10, a11, a12;
};

__device__ __forceinline__ Affine load_affine(const float* __restrict__ aff,
                                              int b) {
  const float* a = aff + 6 * b;
  return {__ldg(a), __ldg(a + 1), __ldg(a + 2),
          __ldg(a + 3), __ldg(a + 4), __ldg(a + 5)};
}

// affine_points' order: a00 * x, a01 * y, their sum, then + a02
__device__ __forceinline__ void map_point(const Affine& a, float gx, float gy,
                                          float& xs, float& ys) {
  xs = __fadd_rn(__fadd_rn(__fmul_rn(a.a00, gx), __fmul_rn(a.a01, gy)),
                 a.a02);
  ys = __fadd_rn(__fadd_rn(__fmul_rn(a.a10, gx), __fmul_rn(a.a11, gy)),
                 a.a12);
}

// bilinear_corners' corners in its order (y0 x0, y0 x1, y1 x0, y1 x1):
// the integer map coordinates of those on the map, and their weights
struct Corners {
  int iy[4], ix[4];
  bool on[4];
  float w[4];
};

__device__ __forceinline__ Corners corners(float xs, float ys, int H, int W) {
  const float y0 = floorf(ys), x0 = floorf(xs);
  const float dy = __fsub_rn(ys, y0), dx = __fsub_rn(xs, x0);
  const float ody = __fsub_rn(1.f, dy), odx = __fsub_rn(1.f, dx);
  const float y1 = __fadd_rn(y0, 1.f), x1 = __fadd_rn(x0, 1.f);
  const float hf = static_cast<float>(H), wf = static_cast<float>(W);
  const bool in_y0 = y0 >= 0.f && y0 < hf, in_y1 = y1 >= 0.f && y1 < hf;
  const bool in_x0 = x0 >= 0.f && x0 < wf, in_x1 = x1 >= 0.f && x1 < wf;
  Corners c;
  c.w[0] = __fmul_rn(ody, odx);
  c.w[1] = __fmul_rn(ody, dx);
  c.w[2] = __fmul_rn(dy, odx);
  c.w[3] = __fmul_rn(dy, dx);
  c.on[0] = in_y0 && in_x0;
  c.on[1] = in_y0 && in_x1;
  c.on[2] = in_y1 && in_x0;
  c.on[3] = in_y1 && in_x1;
  // 0 where off the map: the conversions see in-range values, and the
  // clamped read stays in the image
  const int iy0 = in_y0 ? static_cast<int>(y0) : 0;
  const int iy1 = in_y1 ? static_cast<int>(y1) : 0;
  const int ix0 = in_x0 ? static_cast<int>(x0) : 0;
  const int ix1 = in_x1 ? static_cast<int>(x1) : 0;
  c.iy[0] = iy0; c.ix[0] = ix0;
  c.iy[1] = iy0; c.ix[1] = ix1;
  c.iy[2] = iy1; c.ix[2] = ix0;
  c.iy[3] = iy1; c.ix[3] = ix1;
  return c;
}

__device__ __forceinline__ bool any_on(const Corners& c) {
  return c.on[0] || c.on[1] || c.on[2] || c.on[3];
}

// A pixel with a corner on the map reads all four (an off-map one at a
// clamped place, so that every load is in flight at once) and adds those
// on the map in K3f's order; a pixel with none reads nothing.
template <int N>
__device__ __forceinline__ void accumulate(const Corners& cr,
                                           const float (&v)[4][N],
                                           float (&acc)[N]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      acc[i] = cr.on[c] ? fmaf(cr.w[c], v[c][i], acc[i]) : acc[i];
  }
}

// The pixel route: one thread a pixel of a kTileW x kTileH output tile.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
warp_pixel_kernel(const T* __restrict__ x, const float* __restrict__ aff,
                  T* __restrict__ out, int H, int W, int OH, int OW) {
  const int b = blockIdx.z;
  const int gx = blockIdx.x * kTileW + threadIdx.x % kTileW;
  const int gy = blockIdx.y * kTileH + threadIdx.x / kTileW;
  if (gx >= OW || gy >= OH) return;
  const Affine a = load_affine(aff, b);
  float xs, ys;
  map_point(a, static_cast<float>(gx), static_cast<float>(gy), xs, ys);
  const Corners cr = corners(xs, ys, H, W);
  const size_t image = static_cast<size_t>(b) * H * W;  // pixels before b
  float acc[C] = {};
  if (any_on(cr)) {
    float v[4][C];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T* p =
          x + (image + static_cast<size_t>(cr.iy[c]) * W + cr.ix[c]) * C;
#pragma unroll
      for (int i = 0; i < C; ++i) v[c][i] = ldg_f32(p + i);
    }
    accumulate(cr, v, acc);
  }
  T* o = out + ((static_cast<size_t>(b) * OH + gy) * OW + gx) * C;
#pragma unroll
  for (int i = 0; i < C; ++i) put(o + i, acc[i]);
}

// The vector route: one thread a 16-byte vector (kVec values) of a pixel;
// kAligned where C is a whole number of vectors (16-byte loads and
// stores), else value by value with a tail vector.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
warp_vector_kernel(const T* __restrict__ x, const float* __restrict__ aff,
                   T* __restrict__ out, int H, int W, int C, int OH, int OW,
                   int nv) {
  constexpr int kVec = 16 / sizeof(T);
  const int b = blockIdx.y;
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t total = static_cast<uint32_t>(OH) * OW * nv;
  if (t >= total) return;
  const uint32_t p = t / nv;  // y * OW + x
  const int v = static_cast<int>(t - p * nv);
  const int gy = static_cast<int>(p / OW), gx = static_cast<int>(p % OW);
  const Affine a = load_affine(aff, b);
  float xs, ys;
  map_point(a, static_cast<float>(gx), static_cast<float>(gy), xs, ys);
  const Corners cr = corners(xs, ys, H, W);
  const int c0 = v * kVec;
  const int n = kAligned ? kVec : min(kVec, C - c0);
  const size_t image = static_cast<size_t>(b) * H * W;
  float acc[kVec] = {};
  if (any_on(cr)) {
    float row[4][kVec];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T* src =
          x + (image + static_cast<size_t>(cr.iy[c]) * W + cr.ix[c]) * C + c0;
      if (kAligned) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(src));
        const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
        for (int i = 0; i < kVec; ++i) row[c][i] = to_f32(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          row[c][i] = i < n ? ldg_f32(src + i) : 0.f;
      }
    }
    accumulate(cr, row, acc);
  }
  T* dst = out + (static_cast<size_t>(b) * OH * OW + p) * C + c0;
  if (kAligned) {
    uint4 q;
    T* e = reinterpret_cast<T*>(&q);
#pragma unroll
    for (int i = 0; i < kVec; ++i) put(e + i, acc[i]);
    *reinterpret_cast<uint4*>(dst) = q;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (i < n) put(dst + i, acc[i]);
  }
}

template <typename T, int C>
int launch_pixel(const void* x, const void* aff, void* out, int B, int H,
                 int W, int OH, int OW, cudaStream_t stream) {
  const dim3 grid((OW + kTileW - 1) / kTileW, (OH + kTileH - 1) / kTileH, B);
  warp_pixel_kernel<T, C><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(aff),
      static_cast<T*>(out), H, W, OH, OW);
  return 0;
}

template <typename T>
int launch_vector(const void* x, const void* aff, void* out, int B, int H,
                  int W, int C, int OH, int OW, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int nv = (C + kVec - 1) / kVec;
  const uint64_t total = static_cast<uint64_t>(OH) * OW * nv;
  if (total >= (1ull << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads), B);
  if (C % kVec == 0) {
    warp_vector_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(aff),
        static_cast<T*>(out), H, W, C, OH, OW, nv);
  } else {
    warp_vector_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(aff),
        static_cast<T*>(out), H, W, C, OH, OW, nv);
  }
  return 0;
}

template <typename T>
int launch(const void* x, const void* aff, void* out, int B, int H, int W,
           int C, int OH, int OW, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (C > kVec)
    return launch_vector<T>(x, aff, out, B, H, W, C, OH, OW, stream);
  switch (C) {
    case 1: return launch_pixel<T, 1>(x, aff, out, B, H, W, OH, OW, stream);
    case 2: return launch_pixel<T, 2>(x, aff, out, B, H, W, OH, OW, stream);
    case 3: return launch_pixel<T, 3>(x, aff, out, B, H, W, OH, OW, stream);
    case 4: return launch_pixel<T, 4>(x, aff, out, B, H, W, OH, OW, stream);
  }
  if constexpr (kVec == 8) {
    switch (C) {
      case 5: return launch_pixel<T, 5>(x, aff, out, B, H, W, OH, OW, stream);
      case 6: return launch_pixel<T, 6>(x, aff, out, B, H, W, OH, OW, stream);
      case 7: return launch_pixel<T, 7>(x, aff, out, B, H, W, OH, OW, stream);
      case 8: return launch_pixel<T, 8>(x, aff, out, B, H, W, OH, OW, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The caller guarantees contiguous
// tensors, x and out 16-byte aligned, 1 <= H, W < 2**24, B <= 65535, and
// the grid's limits (warp_affine_plan). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for what it does not take.
extern "C" int bilinear_warp_affine_fwd(const void* x, const void* affines,
                                        void* out, int B, int H, int W,
                                        int C, int OH, int OW, int dtype,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || C < 1 || OH < 1 || OW < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (dtype == 0) {
    err = launch<float>(x, affines, out, B, H, W, C, OH, OW, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, affines, out, B, H, W, C, OH, OW, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
