// What the raster forward (raster_fwd.cu) and backward (raster_bwd.cu)
// kernels share: the blend's constants, the thread-to-pixel mapping, the
// staged entry records and the per-warp cull.
//
// Pixel mapping.  A block owns a tile of tile_h x tile_w pixels and runs
// tile_h * tile_w / PPT threads; each thread owns PPT pixels of one column
// (so the pair terms that depend on dx only are formed once for all of
// them).  A warp owns a compact block of ww x wh pixels (ww = 8 or 16
// columns, wh = 32 * PPT / ww rows): lane l takes column l % ww and rows
// l / ww + k * (32 / ww), k < PPT.  Warp blocks tile the tile row-major.
//
// Per-warp cull.  While a batch is staged, each entry gets a bit mask of
// the warps whose pixel block its alpha >= 1/256 region can reach; a warp
// skips the entries whose bit is clear.  The test is conservative: it
// culls only (entry, warp) pairs for which every pixel of the warp would
// have computed alpha_raw < 1/256 (or NaN) and skipped the entry anyway,
// so colours, transmittances, stops and gradients are unchanged.  The
// pixel's exponent S = q0 + q1 + q2 is formed with seven rounded
// operations, so S >= Q - 16 eps (a dx^2 + c dy^2) with Q the exact form
// (|q1| <= q0 + q2 on a positive-definite form), and alpha_raw >= 1/256
// needs S <= t = 2 ln(256 o) up to a few ulps.  The test takes the
// bounding box of {Q' <= tau} for the form Q' with a and c shrunk by
// 1/256 (far more than the 16 eps needed; shrinking only grows the box)
// and tau = t + (1 + |t|) / 256, and widens the box by 1/16 pixel for the
// rounding of the box's own arithmetic.  An entry is kept everywhere when
// the shrunk form is not positive definite or a number is not finite, and
// culled everywhere when o < 1/256 on a positive-definite form (there
// S >= 0, so alpha_raw <= o).  raster_cuda.warp_block_visible is the
// plain PyTorch version of the same test.
#pragma once
#include <cuda_runtime.h>

namespace litegs {

constexpr float kAlphaMin = 1.0f / 256.0f;
constexpr float kAlphaMax = 255.0f / 256.0f;
constexpr float kTMin = 1.0f / 8192.0f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kCullShrink = 1.0f - 1.0f / 256.0f;
constexpr float kCullSlack = 1.0f / 256.0f;
constexpr float kCullMarginPx = 1.0f / 16.0f;

// The warp blocks of one tile and this thread's pixels in it.
template <int PPT>
struct PixelMap {
  int tile_w, ww, wh, blocks_x, blocks_y;
  int lx, ly0;         // this thread's column and first row in the tile

  __device__ PixelMap(int tile_h, int tile_w_, int ww_, int warp, int lane)
      : tile_w(tile_w_), ww(ww_), wh(32 * PPT / ww_),
        blocks_x(tile_w_ / ww_), blocks_y(tile_h / (32 * PPT / ww_)) {
    lx = (warp % blocks_x) * ww + lane % ww;
    ly0 = (warp / blocks_x) * wh + lane / ww;
  }
  __device__ int row(int k) const { return ly0 + k * (32 / ww); }
  __device__ int pixel(int k) const { return row(k) * tile_w + lx; }
};

// Bit w set: the entry's alpha >= 1/256 region may reach warp w's pixel
// block (see the header note).  tx0, ty0: the tile's first pixel.
__device__ __forceinline__ unsigned warp_mask(float mx, float my, float a,
                                              float b, float c, float op,
                                              float tx0, float ty0, int ww,
                                              int wh, int blocks_x,
                                              int blocks_y) {
  const int nwarps = blocks_x * blocks_y;
  const unsigned all = nwarps == 32 ? kFullMask : (1u << nwarps) - 1u;
  if (!(a > 0.0f && c > 0.0f)) return all;
  const float as = __fmul_rn(a, kCullShrink);
  const float cs = __fmul_rn(c, kCullShrink);
  const float det = __fsub_rn(__fmul_rn(as, cs), __fmul_rn(b, b));
  if (!(det > 0.0f)) return all;
  if (op < kAlphaMin) return 0u;
  const float t = 2.0f * logf(256.0f * op);
  const float tau = t + kCullSlack * (1.0f + fabsf(t));
  const float rx = sqrtf(__fdiv_rn(__fmul_rn(tau, cs), det)) + kCullMarginPx;
  const float ry = sqrtf(__fdiv_rn(__fmul_rn(tau, as), det)) + kCullMarginPx;
  if (!(rx < 1e30f && ry < 1e30f)) return all;
  unsigned xbits = 0u, ybits = 0u;
  for (int i = 0; i < blocks_x; ++i) {
    const float lo = tx0 + static_cast<float>(i * ww);
    const float hi = lo + static_cast<float>(ww - 1);
    if (mx + rx >= lo && mx - rx <= hi) xbits |= 1u << i;
  }
  for (int i = 0; i < blocks_y; ++i) {
    const float lo = ty0 + static_cast<float>(i * wh);
    const float hi = lo + static_cast<float>(wh - 1);
    if (my + ry >= lo && my - ry <= hi) ybits |= 1u << i;
  }
  unsigned mask = 0u;
  for (int i = 0; i < blocks_y; ++i)
    if ((ybits >> i) & 1u) mask |= xbits << (i * blocks_x);
  return mask;
}

// One staged entry: {mx, my, a, 2b}, {c, o}, the colour channels (the
// fourth 0 when C = 3) and the cull mask, in shared memory.
template <int C, int B>
struct Batch {
  float4 geo[B];
  float2 cop[B];
  float4 col[B];
  unsigned mask[B];

  // stage entry e of the batch from point pt
  __device__ void stage(int e, int pt, const float* __restrict__ mean_pix,
                        const float* __restrict__ inv_cov,
                        const float* __restrict__ color,
                        const float* __restrict__ opacity, int m, float tx0,
                        float ty0, int ww, int wh, int blocks_x,
                        int blocks_y) {
    const float mx = mean_pix[pt], my = mean_pix[m + pt];
    const float a = inv_cov[pt], b = inv_cov[m + pt], c = inv_cov[2 * m + pt];
    const float op = opacity[pt];
    // 2b is exact: the plain version's first rounded product
    geo[e] = make_float4(mx, my, a, __fmul_rn(2.0f, b));
    cop[e] = make_float2(c, op);
    const size_t mm = static_cast<size_t>(m);
    col[e] = make_float4(color[pt], color[mm + pt], color[2 * mm + pt],
                         C == 4 ? color[3 * mm + pt] : 0.0f);
    mask[e] = warp_mask(mx, my, a, b, c, op, tx0, ty0, ww, wh, blocks_x,
                        blocks_y);
  }
};

// alpha_raw of the pair (entry, pixel) given the entry-and-column terms
// q0 = (a dx) dx and t1 = (2b) dx: the plain version's exponent, operation
// for operation, each rounded on its own (no fused multiply-add), so the
// 1/256 cut falls on the same pairs.
__device__ __forceinline__ float pair_alpha(float q0, float t1, float dy,
                                            float c, float op) {
  const float q1 = __fmul_rn(t1, dy);
  const float q2 = __fmul_rn(__fmul_rn(c, dy), dy);
  const float power = __fmul_rn(-0.5f, __fadd_rn(__fadd_rn(q0, q1), q2));
  return __fmul_rn(op, expf(power));
}

__device__ __forceinline__ float channel(const float4& v, int ch) {
  return ch == 0 ? v.x : ch == 1 ? v.y : ch == 2 ? v.z : v.w;
}

// Tile shapes the kernels take for PPT pixels per thread: the warp block
// width (8 or 16) whose blocks tile the tile exactly, or 0.
inline int warp_block_width(int tile_h, int tile_w, int ppt) {
  if (tile_h * tile_w > 1024 || tile_h <= 0 || tile_w <= 0) return 0;
  for (int ww : {8, 16}) {
    const int wh = 32 * ppt / ww;
    if (wh > 0 && tile_w % ww == 0 && tile_h % wh == 0) return ww;
  }
  return 0;
}

}  // namespace litegs
