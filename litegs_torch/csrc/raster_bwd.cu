// Raster backward kernel for Hopper (sm_90a): per-point gradients of the
// front-to-back blend, and optionally the fragment statistics.
//
// Replaces litegs_tpu/ops/raster_pallas.py::_bwd_kernel, reduced to points.
// Grid, threads and batches are the forward kernel's (raster_fwd.cu): one
// thread block per tile, one thread per pixel (blockDim = tile_h * tile_w,
// a multiple of 32, <= 1024), the tile's entries staged in shared memory
// in batches of blockDim.
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
// Reduction: each entry's K partial sums are reduced across a warp with
// shuffles (skipped when no lane of the warp touched the entry), written
// per warp to shared memory, summed across the warps for a round of kSub
// entries, and added once per entry to the per-point outputs with
// atomicAdd.  The output is one zero-initialised [K, M] array:
//   rows 0..C-1 d_color, C..C+1 d_mean, C+2..C+4 d_inv_cov,
//   C+5 d_opacity, then (statistics) weight_sum, frag_count, err_square_sum.
// The block stops once every pixel has saturated (__syncthreads_count).
#include <cuda_runtime.h>

namespace {

constexpr float kAlphaMin = 1.0f / 256.0f;
constexpr float kAlphaMax = 255.0f / 256.0f;
constexpr float kTMin = 1.0f / 8192.0f;
constexpr int kSub = 32;                 // entries per cross-warp round
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

template <int C, bool STATS>
struct Layout {
  static constexpr int kMean = C;
  static constexpr int kInvCov = C + 2;
  static constexpr int kOpacity = C + 5;
  static constexpr int kWeight = C + 6;
  static constexpr int kCount = C + 7;
  static constexpr int kErr2 = C + 8;
  static constexpr int K = STATS ? C + 9 : C + 6;
};

template <int C, bool STATS>
__global__ void raster_bwd_kernel(
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
    float* __restrict__ grads,            // [K, M] zero-initialised
    int m, int tiles_x, int tile_w) {
  using L = Layout<C, STATS>;
  constexpr int K = L::K;
  extern __shared__ float smem[];
  const int npix = blockDim.x;
  const int nwarps = npix >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  float* s_mx = smem;
  float* s_my = s_mx + npix;
  float* s_a = s_my + npix;
  float* s_b = s_a + npix;
  float* s_c = s_b + npix;
  float* s_op = s_c + npix;
  float* s_col = s_op + npix;                         // [C, npix]
  int* s_pt = reinterpret_cast<int*>(s_col + C * npix);  // [npix]
  float* s_red = reinterpret_cast<float*>(s_pt + npix);  // [nwarps, kSub, K]

  const int tile_h = npix / tile_w;
  const float px = static_cast<float>((tile % tiles_x) * tile_w + tid % tile_w);
  const float py = static_cast<float>((tile / tiles_x) * tile_h + tid / tile_w);
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  const size_t pix = static_cast<size_t>(tile) * npix + tid;
  float dC[C];
  float D0 = out_trans[pix] * d_trans[pix];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const size_t at = (static_cast<size_t>(tile) * C + ch) * npix + tid;
    dC[ch] = d_color[at];
    D0 += dC[ch] * out_color[at];
  }

  float T = 1.0f;
  float prefix = 0.0f;
  bool done = false;

  for (int base = 0; base < count; base += npix) {
    // also the barrier before the batch's shared memory is overwritten
    if (__syncthreads_count(done) == npix) break;
    const int e = base + tid;
    if (e < count) {
      const int pt = sorted_point[start + e];
      s_pt[tid] = pt;
      s_mx[tid] = mean_pix[pt];
      s_my[tid] = mean_pix[m + pt];
      s_a[tid] = inv_cov[pt];
      s_b[tid] = inv_cov[m + pt];
      s_c[tid] = inv_cov[2 * m + pt];
      s_op[tid] = opacity[pt];
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        s_col[ch * npix + tid] = color[static_cast<size_t>(ch) * m + pt];
    }
    __syncthreads();
    const int n = min(npix, count - base);
    for (int sb = 0; sb < n; sb += kSub) {
      const int ns = min(kSub, n - sb);
      for (int jj = 0; jj < ns; ++jj) {
        const int j = sb + jj;
        float v[K];
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = 0.0f;
        bool hit = false;
        if (!done) {
          // the forward's exponent, operation for operation (raster_fwd.cu)
          const float dx = s_mx[j] - px;
          const float dy = s_my[j] - py;
          const float q0 = __fmul_rn(__fmul_rn(s_a[j], dx), dx);
          const float q1 =
              __fmul_rn(__fmul_rn(__fmul_rn(2.0f, s_b[j]), dx), dy);
          const float q2 = __fmul_rn(__fmul_rn(s_c[j], dy), dy);
          const float power =
              __fmul_rn(-0.5f, __fadd_rn(__fadd_rn(q0, q1), q2));
          const float alpha_raw = __fmul_rn(s_op[j], expf(power));
          if (alpha_raw >= kAlphaMin) {  // NaN is skipped too
            hit = true;
            const float alpha = fminf(alpha_raw, kAlphaMax);
            const float w = alpha * T;
            float g1 = 0.0f;
#pragma unroll
            for (int ch = 0; ch < C; ++ch) {
              g1 += s_col[ch * npix + j] * dC[ch];
              v[ch] = dC[ch] * w;
            }
            prefix += g1 * w;
            const float d_alpha = g1 * T - (D0 - prefix) / (1.0f - alpha);
            const float dpw = d_alpha * alpha_raw;
            const float a = s_a[j], b = s_b[j], c = s_c[j];
            v[L::kMean] = -(a * dx + b * dy) * dpw;
            v[L::kMean + 1] = -(b * dx + c * dy) * dpw;
            v[L::kInvCov] = -0.5f * dx * dx * dpw;
            v[L::kInvCov + 1] = -dx * dy * dpw;
            v[L::kInvCov + 2] = -0.5f * dy * dy * dpw;
            v[L::kOpacity] = dpw;
            if constexpr (STATS) {
              v[L::kWeight] = w;
              v[L::kCount] = 1.0f;
              v[L::kErr2] = dpw * dpw;
            }
            T *= 1.0f - alpha;
            if (T <= kTMin) done = true;
          }
        }
        if (__any_sync(kFullMask, hit)) {
#pragma unroll
          for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < K; ++k) s_red[(warp * kSub + jj) * K + k] = v[k];
        }
      }
      __syncthreads();
      for (int idx = tid; idx < ns * K; idx += npix) {
        const int jj = idx / K;
        const int k = idx - jj * K;
        float s = 0.0f;
        for (int wi = 0; wi < nwarps; ++wi) s += s_red[(wi * kSub + jj) * K + k];
        if (s != 0.0f) {
          const float o = fmaxf(s_op[sb + jj], 1e-12f);
          if (k == L::kOpacity) s /= o;
          if (STATS && k == L::kErr2) s /= o * o;
          atomicAdd(grads + static_cast<size_t>(k) * m + s_pt[sb + jj], s);
        }
      }
      // s_red is rewritten by the next round
      __syncthreads();
    }
  }
}

template <int C, bool STATS>
int launch(const void* mean_pix, const void* inv_cov, const void* color,
           const void* opacity, const void* sorted_point,
           const void* tile_start, const void* tile_count,
           const void* out_color, const void* out_trans, const void* d_color,
           const void* d_trans, void* grads, int m, int tiles_total,
           int tiles_x, int tile_w, int npix, cudaStream_t s) {
  const size_t smem =
      (static_cast<size_t>(6 + C) * npix + npix +
       static_cast<size_t>(npix / 32) * kSub * Layout<C, STATS>::K) *
      sizeof(float);
  auto kernel = raster_bwd_kernel<C, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tiles_total, npix, smem, s>>>(
      static_cast<const float*>(mean_pix), static_cast<const float*>(inv_cov),
      static_cast<const float*>(color), static_cast<const float*>(opacity),
      static_cast<const int*>(sorted_point),
      static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_count),
      static_cast<const float*>(out_color),
      static_cast<const float*>(out_trans),
      static_cast<const float*>(d_color), static_cast<const float*>(d_trans),
      static_cast<float*>(grads), m, tiles_x, tile_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int litegs_raster_backward(
    const void* mean_pix, const void* inv_cov, const void* color,
    const void* opacity, const void* sorted_point, const void* tile_start,
    const void* tile_count, const void* out_color, const void* out_trans,
    const void* d_color, const void* d_trans, void* grads, int m,
    int channels, int with_stats, int tiles_total, int tiles_x, int tile_h,
    int tile_w, void* stream) {
  const int npix = tile_h * tile_w;
  if (npix <= 0 || npix > 1024 || npix % 32 != 0 ||
      (channels != 3 && channels != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles_total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LITEGS_LAUNCH(CH, ST)                                                \
  return launch<CH, ST>(mean_pix, inv_cov, color, opacity, sorted_point,     \
                        tile_start, tile_count, out_color, out_trans,        \
                        d_color, d_trans, grads, m, tiles_total, tiles_x,    \
                        tile_w, npix, s)
  if (channels == 3) {
    if (with_stats) LITEGS_LAUNCH(3, true);
    LITEGS_LAUNCH(3, false);
  }
  if (with_stats) LITEGS_LAUNCH(4, true);
  LITEGS_LAUNCH(4, false);
#undef LITEGS_LAUNCH
}

extern "C" const char* litegs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
