// Raster forward kernel for Hopper (sm_90a): front-to-back alpha blend of
// each tile's depth-sorted table entries.
//
// Replaces litegs_tpu/ops/raster_pallas.py::_fwd_kernel. One thread block
// per tile; each thread owns one pixel and each warp a compact 8x4 or
// 16x2 block of the tile (raster_common.cuh). The block walks its tile's
// entries [tile_start, tile_start + tile_count) in batches of kBatch: the
// threads gather the batch's point attributes into shared memory as float4
// records with a per-warp cull mask, the block syncs, and every warp walks
// the batch front to back, skipping the entries its mask bit culls.
//
// Per (entry, pixel):
//   dx = mean_x - px, dy = mean_y - py      (integer pixel coordinates)
//   power = -0.5 * (a dx^2 + 2 b dx dy + c dy^2),  alpha = o * expf(power)
//   alpha < 1/256 skips the entry; alpha is clamped to 255/256;
//   while T > 1/8192: w = alpha T is added to each channel, T *= 1 - alpha.
// The first T <= 1/8192 is the pixel's final transmittance.  A warp stops
// once all its pixels have saturated, the block once all its warps have
// (__syncthreads_count).  power and alpha are formed with
// explicitly rounded operations in the plain PyTorch version's order
// (pair_alpha), so the 1/256 cut falls on the same entries in both.
//
// What bounds it on the H100: the FP32 and exp issue per (entry, pixel)
// pair walked (about fifteen operations and an accurate expf) and the
// latency of each pair's dependent chain; the bytes it moves are small.
// The design: the cull drops the pairs of the warps an entry cannot
// reach; an entry is read as two 16-byte and one 8-byte shared loads
// instead of nine scalar ones; and a warp votes on its exit every
// kExitEvery entries and stops without waiting for its block (a vote per
// entry cost more than it saved).  One pixel per thread was faster than
// two or four, whose wider warp blocks cull fewer pairs (PERF.md).
//
// Optional outputs, for measuring the work a frame needs, each written
// when its pointer is not null: walked[pixel] = the entries up to and
// including its stop (or the tile's count), culled or not, as the kernel
// without the cull walked them; evaluated[pixel] = the pairs of those that
// it did not cull; contributing[pixel] = the pairs of those with alpha >=
// 1/256, the ones that the blend takes.
#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using namespace litegs;

constexpr int kBatch = 256;
constexpr int kExitEvery = 16;
constexpr int kPPT = 1;   // pixels per thread

template <int C, bool COUNT>
__global__ void __launch_bounds__(1024) raster_fwd_kernel(
    const float* __restrict__ mean_pix,   // [2, M]
    const float* __restrict__ inv_cov,    // [3, M]
    const float* __restrict__ color,      // [C, M]
    const float* __restrict__ opacity,    // [M]
    const int* __restrict__ sorted_point, // [E]
    const int* __restrict__ tile_start,   // [T]
    const int* __restrict__ tile_count,   // [T]
    float* __restrict__ out_color,        // [T, C, P]
    float* __restrict__ out_trans,        // [T, P]
    int* __restrict__ walked,             // [T, P] or nullptr
    int* __restrict__ evaluated,          // [T, P] or nullptr
    int* __restrict__ contributing,       // [T, P] or nullptr
    int m, int tiles_x, int tiles_y, int tile_h, int tile_w, int ww) {
  __shared__ Batch<C, kBatch> s;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int npix = tile_h * tile_w;
  const PixelMap<kPPT> map(tile_h, tile_w, ww, warp, lane);
  const float tx0 = static_cast<float>((tile % tiles_x) * tile_w);
  // tiles_y > 0: a merged grid of several views, whose tile row wraps
  // modulo each view's tiles_y
  const int trow = tiles_y > 0 ? (tile / tiles_x) % tiles_y : tile / tiles_x;
  const float ty0 = static_cast<float>(trow * tile_h);
  const float px = tx0 + static_cast<float>(map.lx);
  const float py = ty0 + static_cast<float>(map.row(0));
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const unsigned wbit = 1u << warp;

  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
  float T = 1.0f;
  bool done = false;
  int stop = count, n_eval = 0, n_contrib = 0;

  for (int base = 0; base < count; base += kBatch) {
    // also the barrier before the batch's shared memory is overwritten
    if (__syncthreads_count(done) == nthreads) break;
    const int n = min(kBatch, count - base);
    for (int e = tid; e < n; e += nthreads)
      s.stage(e, sorted_point[start + base + e], mean_pix, inv_cov, color,
              opacity, m, tx0, ty0, map.ww, map.wh, map.blocks_x,
              map.blocks_y);
    __syncthreads();
    if (__all_sync(kFullMask, done)) continue;
    for (int j = 0; j < n; ++j) {
      if (!(s.mask[j] & wbit)) continue;  // the same for the whole warp
      const float4 g = s.geo[j];
      const float2 co = s.cop[j];
      const float dx = g.x - px;
      const float q0 = __fmul_rn(__fmul_rn(g.z, dx), dx);
      const float t1 = __fmul_rn(g.w, dx);
      const float alpha_raw = pair_alpha(q0, t1, g.y - py, co.x, co.y);
      if (!done) {
        if (COUNT) ++n_eval;
        if (alpha_raw >= kAlphaMin) {  // NaN is skipped too
          if (COUNT) ++n_contrib;
          const float alpha = fminf(alpha_raw, kAlphaMax);
          const float w = alpha * T;
          const float4 col = s.col[j];
#pragma unroll
          for (int ch = 0; ch < C; ++ch) acc[ch] += w * channel(col, ch);
          T *= 1.0f - alpha;
          if (T <= kTMin) {
            done = true;
            stop = base + j + 1;
          }
        }
      }
      // a vote every kExitEvery entries: one per entry costs more than
      // the entries a saturated warp would walk in between
      if ((j & (kExitEvery - 1)) == kExitEvery - 1 &&
          __all_sync(kFullMask, done))
        break;
    }
  }

  const int p = map.pixel(0);
  const size_t pix = static_cast<size_t>(tile) * npix + p;
#pragma unroll
  for (int ch = 0; ch < C; ++ch)
    out_color[(static_cast<size_t>(tile) * C + ch) * npix + p] = acc[ch];
  out_trans[pix] = T;
  if (COUNT) {
    if (walked != nullptr) walked[pix] = stop;
    if (evaluated != nullptr) evaluated[pix] = n_eval;
    if (contributing != nullptr) contributing[pix] = n_contrib;
  }
}

template <int C, bool COUNT>
int launch(const void* mean_pix, const void* inv_cov, const void* color,
           const void* opacity, const void* sorted_point,
           const void* tile_start, const void* tile_count, void* out_color,
           void* out_trans, void* walked, void* evaluated,
           void* contributing, int m, int tiles_total, int tiles_x,
           int tiles_y, int tile_h, int tile_w, int ww, cudaStream_t s) {
  raster_fwd_kernel<C, COUNT><<<tiles_total, tile_h * tile_w / kPPT, 0, s>>>(
          static_cast<const float*>(mean_pix),
          static_cast<const float*>(inv_cov),
          static_cast<const float*>(color),
          static_cast<const float*>(opacity),
          static_cast<const int*>(sorted_point),
          static_cast<const int*>(tile_start),
          static_cast<const int*>(tile_count),
          static_cast<float*>(out_color), static_cast<float*>(out_trans),
          static_cast<int*>(walked), static_cast<int*>(evaluated),
          static_cast<int*>(contributing), m, tiles_x, tiles_y, tile_h,
          tile_w, ww);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// walked, evaluated, contributing: each [T, P] int32 or null.  tiles_y:
// the tile rows of one view on a merged grid of several views (the tile
// row wraps modulo it), 0 for one view.
extern "C" int litegs_raster_forward(
    const void* mean_pix, const void* inv_cov, const void* color,
    const void* opacity, const void* sorted_point, const void* tile_start,
    const void* tile_count, void* out_color, void* out_trans, void* walked,
    void* evaluated, void* contributing, int m, int channels,
    int tiles_total, int tiles_x, int tiles_y, int tile_h, int tile_w,
    void* stream) {
  const int ww = litegs::warp_block_width(tile_h, tile_w, kPPT);
  if (ww == 0 || (channels != 3 && channels != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles_total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LITEGS_LAUNCH(CH, CNT)                                              \
  return launch<CH, CNT>(mean_pix, inv_cov, color, opacity, sorted_point,   \
                         tile_start, tile_count, out_color, out_trans,      \
                         walked, evaluated, contributing, m, tiles_total,   \
                         tiles_x, tiles_y, tile_h, tile_w, ww, s)
  const bool count = walked != nullptr || evaluated != nullptr ||
                     contributing != nullptr;
  if (channels == 3) {
    if (count) LITEGS_LAUNCH(3, true);
    LITEGS_LAUNCH(3, false);
  }
  if (count) LITEGS_LAUNCH(4, true);
  LITEGS_LAUNCH(4, false);
#undef LITEGS_LAUNCH
}

// The tile shapes the kernel takes: 1 if tile_h x tile_w is one of them.
extern "C" int litegs_raster_forward_takes(int tile_h, int tile_w) {
  return litegs::warp_block_width(tile_h, tile_w, kPPT) != 0;
}

extern "C" const char* litegs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
