// Raster backward kernel for Hopper (sm_90a): per-point gradients of the
// front-to-back blend, and optionally the fragment statistics.
//
// Replaces litegs_tpu/ops/raster_pallas.py::_bwd_kernel, reduced to points.
// Grid, pixel mapping, staged records and per-warp cull are the forward
// kernel's (raster_fwd.cu, raster_common.cuh): one thread block per tile,
// two pixels of one column per thread and an 8x8 or 16x4 pixel block per
// warp, the tile's entries staged in shared memory in batches of kBatch.
//
// Each pixel re-walks its entries in forward order, recomputing alpha and
// the transmittance T with the forward's operations in the forward's order
// (so its stop falls on the same entry), and reads its cotangent once:
//   D0      = sum_c dC_c C_total_c + T_fin dT
//   prefix += (c . dC) w                 w = alpha T   (inclusive)
//   d_alpha = (c . dC) T - (D0 - prefix) / (1 - alpha)
//   dpw     = d_alpha * alpha_raw        straight through the 255/256 clamp
// and forms the pair's partial gradients directly (dx = mean_x - px):
//   d_mean    = -(a dx + b dy, b dx + c dy) dpw
//   d_inv_cov = -(dx^2 / 2, dx dy, dy^2 / 2) dpw
//   d_color   = dC w,   sum dpw (-> d_opacity = sum dpw / o)
// and, with statistics, w, 1 and dpw^2 (-> err^2 = sum dpw^2 / o^2).
//
// What bounds it on the H100, and what the design does about it:
//   * the reduction of each entry's K = C + 6 (+ 3) partial sums across
//     the tile's pixels.  A thread first adds its two pixels' terms; then,
//     for each entry that some lane of the warp touched, a reduce-scatter
//     butterfly over the K columns padded to 16 (each step sends half of
//     the remaining columns and keeps the other half summed: 8 + 4 + 2 + 1
//     + 1 = 16 shuffles, where a butterfly per column takes 5 K) leaves
//     column k's warp sum in lane pair (2 k', 2 k' + 1).  Its steps must
//     unroll with constant indices: written as one loop, the compiler
//     indexed v[] through predicated moves and branches, and the kernel
//     ran slower than with a butterfly per column;
//   * the sum across warps: one shared-memory atomic add per column and
//     warp (a compare-and-swap loop on this card, so one instruction per
//     warp-entry rather than K) into the batch's [kBatch, 16] accumulator;
//     the block meets three times per batch rather than twice per 32
//     entries;
//   * the adds into the per-point outputs: after each batch, each entry's
//     nonzero columns go out as 16-byte vector atomics (sm_90) into a
//     point-major [M, KP] array (KP = K rounded up to 4), one or two
//     32-byte segments per entry where the [K, M] layout touched K lines;
//     the wrapper transposes it once;
//   * the per-pair FP32 work (about forty operations for a pair that
//     contributes): the cull drops warps the entry cannot reach, a
//     thread's pixels share the dx-only terms and the shared-memory reads,
//     their alphas are formed before any blend, and the division by
//     1 - alpha (in [1/256, 1)) is __fdividef, within 2 ulp of the IEEE
//     quotient, instead of the division routine.
// Output columns: 0..C-1 d_color, C..C+1 d_mean, C+2..C+4 d_inv_cov, C+5
// d_opacity, then (statistics) weight_sum, frag_count, err_square_sum.
#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using namespace litegs;

constexpr int kBatch = 128;
// pixels per thread: two were faster than one or four (PERF.md)
constexpr int kPPT = 2;

template <int C, bool STATS>
struct Layout {
  static constexpr int kMean = C;
  static constexpr int kInvCov = C + 2;
  static constexpr int kOpacity = C + 5;
  static constexpr int kWeight = C + 6;
  static constexpr int kCount = C + 7;
  static constexpr int kErr2 = C + 8;
  static constexpr int K = STATS ? C + 9 : C + 6;
  static constexpr int KP = (K + 3) / 4 * 4;   // point-major row length
};

// One step of the reduce-scatter: lanes with (lane & OFF) keep the upper
// HALF of v[0..2 HALF), the others the lower, each adding its partner's
// copy of the half it keeps.  Unrolled with constant indices, so the
// selects stay in registers.
template <int HALF, int OFF>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[16], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(kFullMask, send, OFF);
  }
}

// Reduce-scatter of v[0..15] across the warp: afterwards v[0] of lanes
// 2 i and 2 i + 1 holds the warp's sum of column reduced_column(lane).
__device__ __forceinline__ void reduce_scatter16(float (&v)[16], int lane) {
  reduce_scatter_step<8, 16>(v, lane);
  reduce_scatter_step<4, 8>(v, lane);
  reduce_scatter_step<2, 4>(v, lane);
  reduce_scatter_step<1, 2>(v, lane);
  v[0] += __shfl_xor_sync(kFullMask, v[0], 1);
}

__device__ __forceinline__ int reduced_column(int lane) {
  return ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
         ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
}

__device__ __forceinline__ void red_add_v4(float* addr, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(addr), v);
}

template <int C, bool STATS>
__global__ void __launch_bounds__(1024 / kPPT) raster_bwd_kernel(
    const float* __restrict__ mean_pix,   // [2, M]
    const float* __restrict__ inv_cov,    // [3, M]
    const float* __restrict__ color,      // [C, M]
    const float* __restrict__ opacity,    // [M]
    const int* __restrict__ sorted_point, // [E]
    const int* __restrict__ tile_start,   // [T]
    const int* __restrict__ tile_count,   // [T]
    const float* __restrict__ out_color,  // [T, C, P] forward output
    const float* __restrict__ out_trans,  // [T, P]    forward output
    const float* __restrict__ d_color,    // [T, C, P] cotangent
    const float* __restrict__ d_trans,    // [T, P]    cotangent
    float* __restrict__ grads,            // [M, KP] zero-initialised
    int m, int tiles_x, int tiles_y, int tile_h, int tile_w, int ww) {
  using L = Layout<C, STATS>;
  constexpr int K = L::K;
  constexpr int KP = L::KP;
  constexpr int kGroups = KP / 4;
  __shared__ Batch<C, kBatch> s;
  __shared__ int s_pt[kBatch];
  __shared__ float4 s_acc[kBatch * 4];     // [kBatch, 16] column sums
  float* s_accf = reinterpret_cast<float*>(s_acc);

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
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const unsigned wbit = 1u << warp;
  const int my_col = reduced_column(lane);

  float py[kPPT], dC[kPPT][C], D0[kPPT], T[kPPT], prefix[kPPT];
  bool done[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    py[k] = ty0 + static_cast<float>(map.row(k));
    const size_t pix = static_cast<size_t>(tile) * npix + map.pixel(k);
    D0[k] = out_trans[pix] * d_trans[pix];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const size_t at =
          (static_cast<size_t>(tile) * C + ch) * npix + map.pixel(k);
      dC[k][ch] = d_color[at];
      D0[k] += dC[k][ch] * out_color[at];
    }
    T[k] = 1.0f;
    prefix[k] = 0.0f;
    done[k] = false;
  }
  auto all_done = [&]() {
    bool d = true;
#pragma unroll
    for (int k = 0; k < kPPT; ++k) d = d && done[k];
    return d;
  };
  for (int i = tid; i < kBatch * 4; i += nthreads)
    s_acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int base = 0; base < count; base += kBatch) {
    // also the barrier between the last batch's flush and this staging
    if (__syncthreads_count(all_done()) == nthreads) break;
    const int n = min(kBatch, count - base);
    for (int e = tid; e < n; e += nthreads) {
      const int pt = sorted_point[start + base + e];
      s_pt[e] = pt;
      s.stage(e, pt, mean_pix, inv_cov, color, opacity, m, tx0, ty0, map.ww,
              map.wh, map.blocks_x, map.blocks_y);
    }
    __syncthreads();
    if (!__all_sync(kFullMask, all_done())) {
      for (int j = 0; j < n; ++j) {
        if (!(s.mask[j] & wbit)) continue;  // the same for the whole warp
        const float4 g = s.geo[j];
        const float2 co = s.cop[j];
        const float a = g.z, b = 0.5f * g.w, c = co.x;
        const float dx = g.x - px;
        const float q0 = __fmul_rn(__fmul_rn(a, dx), dx);
        const float t1 = __fmul_rn(g.w, dx);
        float v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = 0.0f;
        bool hit = false;
        // every pixel's alpha first (independent chains), then the blend
        float alpha_raws[kPPT];
#pragma unroll
        for (int k = 0; k < kPPT; ++k)
          alpha_raws[k] = pair_alpha(q0, t1, g.y - py[k], c, co.y);
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
          const float dy = g.y - py[k];
          const float alpha_raw = alpha_raws[k];
          // NaN is skipped too; a saturated pixel takes no more entries
          if (done[k] || !(alpha_raw >= kAlphaMin)) continue;
          hit = true;
          const float alpha = fminf(alpha_raw, kAlphaMax);
          const float w = alpha * T[k];
          const float4 col = s.col[j];
          float g1 = 0.0f;
#pragma unroll
          for (int ch = 0; ch < C; ++ch) {
            g1 += channel(col, ch) * dC[k][ch];
            v[ch] += dC[k][ch] * w;
          }
          prefix[k] += g1 * w;
          const float d_alpha =
              g1 * T[k] - __fdividef(D0[k] - prefix[k], 1.0f - alpha);
          const float dpw = d_alpha * alpha_raw;
          v[L::kMean] += -(a * dx + b * dy) * dpw;
          v[L::kMean + 1] += -(b * dx + c * dy) * dpw;
          v[L::kInvCov] += -0.5f * dx * dx * dpw;
          v[L::kInvCov + 1] += -dx * dy * dpw;
          v[L::kInvCov + 2] += -0.5f * dy * dy * dpw;
          v[L::kOpacity] += dpw;
          if constexpr (STATS) {
            v[L::kWeight] += w;
            v[L::kCount] += 1.0f;
            v[L::kErr2] += dpw * dpw;
          }
          T[k] *= 1.0f - alpha;
          if (T[k] <= kTMin) done[k] = true;
        }
        if (__any_sync(kFullMask, hit)) {
          reduce_scatter16(v, lane);
          if (!(lane & 1) && my_col < K)
            atomicAdd(s_accf + j * 16 + my_col, v[0]);
        }
        if (__all_sync(kFullMask, all_done())) break;
      }
    }
    __syncthreads();
    // flush: each entry's column sums to its point, then clear them
    for (int idx = tid; idx < n * kGroups; idx += nthreads) {
      const int j = idx / kGroups;
      const int grp = idx - j * kGroups;
      float4 v = s_acc[j * 4 + grp];
      if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f) {
        const float o = fmaxf(s.cop[j].y, 1e-12f);
        float* f = reinterpret_cast<float*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = grp * 4 + i;
          if (col == L::kOpacity) f[i] /= o;
          if (STATS && col == L::kErr2) f[i] /= o * o;
        }
        red_add_v4(grads + static_cast<size_t>(s_pt[j]) * KP + grp * 4, v);
        s_acc[j * 4 + grp] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
}

template <int C, bool STATS>
int launch(const void* mean_pix, const void* inv_cov, const void* color,
           const void* opacity, const void* sorted_point,
           const void* tile_start, const void* tile_count,
           const void* out_color, const void* out_trans, const void* d_color,
           const void* d_trans, void* grads, int m, int tiles_total,
           int tiles_x, int tiles_y, int tile_h, int tile_w, int ww,
           cudaStream_t s) {
  raster_bwd_kernel<C, STATS>
      <<<tiles_total, tile_h * tile_w / kPPT, 0, s>>>(
          static_cast<const float*>(mean_pix),
          static_cast<const float*>(inv_cov),
          static_cast<const float*>(color),
          static_cast<const float*>(opacity),
          static_cast<const int*>(sorted_point),
          static_cast<const int*>(tile_start),
          static_cast<const int*>(tile_count),
          static_cast<const float*>(out_color),
          static_cast<const float*>(out_trans),
          static_cast<const float*>(d_color),
          static_cast<const float*>(d_trans), static_cast<float*>(grads), m,
          tiles_x, tiles_y, tile_h, tile_w, ww);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grads: a zero-initialised point-major [M, KP] array, KP =
// litegs_raster_backward_row(channels, with_stats).  tiles_y as in
// litegs_raster_forward.
extern "C" int litegs_raster_backward(
    const void* mean_pix, const void* inv_cov, const void* color,
    const void* opacity, const void* sorted_point, const void* tile_start,
    const void* tile_count, const void* out_color, const void* out_trans,
    const void* d_color, const void* d_trans, void* grads, int m,
    int channels, int with_stats, int tiles_total, int tiles_x, int tiles_y,
    int tile_h, int tile_w, void* stream) {
  const int ww = litegs::warp_block_width(tile_h, tile_w, kPPT);
  if (ww == 0 || (channels != 3 && channels != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles_total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LITEGS_LAUNCH(CH, ST)                                                \
  return launch<CH, ST>(mean_pix, inv_cov, color, opacity, sorted_point,     \
                        tile_start, tile_count, out_color, out_trans,        \
                        d_color, d_trans, grads, m, tiles_total, tiles_x,    \
                        tiles_y, tile_h, tile_w, ww, s)
  if (channels == 3) {
    if (with_stats) LITEGS_LAUNCH(3, true);
    LITEGS_LAUNCH(3, false);
  }
  if (with_stats) LITEGS_LAUNCH(4, true);
  LITEGS_LAUNCH(4, false);
#undef LITEGS_LAUNCH
}

// The row length of the point-major output: K rounded up to 4.
extern "C" int litegs_raster_backward_row(int channels, int with_stats) {
  return (channels + 6 + (with_stats ? 3 : 0) + 3) / 4 * 4;
}

// The tile shapes the kernel takes: 1 if tile_h x tile_w is one of them.
extern "C" int litegs_raster_backward_takes(int tile_h, int tile_w) {
  return litegs::warp_block_width(tile_h, tile_w, kPPT) != 0;
}

extern "C" const char* litegs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
