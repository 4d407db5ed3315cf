// Tile binning by (tile, depth) keys for Hopper (sm_90a): count, emit, sort
// and ranges, the pipeline of the reference's binning.cu:33-110 (count ->
// scan -> duplicate-with-keys -> sort -> ranges).
//
//   bin_count_kernel    one thread per point: the visibility test, the
//                       clipped tile rect, the tightened row range and
//                       every row's exact x-span (speedy-splat's slab
//                       walk), giving the point's row count and entry
//                       count; the totals and the range of the emitting
//                       points' view-z bits (one atomic each per block)
//   bin_emit_kernel     one thread per point again: each entry's key
//                       (tile << zb | view-z bits - the least of them, zb
//                       the width of that difference) and point id, at the
//                       point's offset in the scan of the entry counts
//   bin_sort_count_kernel,
//   bin_sort_scatter_kernel
//                       one stable LSD radix sort of the (key, point)
//                       pairs, 8 bits a pass over the key's tile + zb bits
//                       only: a block histogram of each 4096-entry tile's
//                       digits, then each tile sorted by its digit in
//                       shared memory (CUB's BlockRadixSort) and scattered
//                       to the digit's offset (the scan of the digit-major
//                       histograms, a torch.cumsum between the two)
//   bin_ranges_kernel   one thread per boundary of the sorted keys: each
//                       tile's start and count, and the int32 tile column
//
// Emitted in point order and sorted stably, the entries of one tile come
// out by ascending depth, ties by point index -- the order a stable depth
// sort of the points followed by a stable tile sort of the entries gives.
// View z is > 0.2 for every emitting point, so its float bits order as
// unsigned integers.
//
// These kernels replace no Pallas kernel: the JAX package builds its table
// with XLA ops around the expansion kernels that stream_gather.cu ports.
// They replace the port's chain of PyTorch ops (ops/binning.py, whose
// plain version of this route, _table_by_keys_plain, is the same algorithm
// in tensor ops).  The table is integers and must equal the one that chain
// builds on the card bit for bit, so every float operation rounds as the
// chain's PyTorch CUDA op does: each product, sum, quotient and root is
// rounded on its own (__fmul_rn and friends, no contraction into FMAs), a
// division by a Python number is PyTorch's multiplication by its float
// reciprocal, and min, max and clamp pass NaN through as torch's do.
//
// What bounds them on the H100: bytes.  Count and emit each read a point's
// eight input words (32 bytes) once, and emit writes 12 bytes an entry; the
// row arithmetic is a few dozen operations a row, far below the card's
// rate.  The sort moves 32 bytes an entry a pass (the histogram reads the
// key, the scatter reads and writes the pair), so its passes are the bulk
// of the route's bytes and time: the key keeps only the bits that vary
// (the tile's and the depth range's, 38 of 64 on the 6M serving view at
// 8x16 tiles), five passes where a 64-bit sort takes eight.
//
// Entry counts differ by three orders of magnitude between points (a
// few giant splats cover thousands of tiles), so a point with more than
// kLong rows (count) or entries (emit) is shared by its warp: the lanes
// take its rows 32 at a time, scan their entry counts by shuffles and write
// its entries coalesced, while short points stay one a thread and write
// their few entries in a row.
#include <cuda_runtime.h>

#include <cub/block/block_load.cuh>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLong = 32;  // above this a point is shared by its warp
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kIntRange = 1073741824.0f;  // 2^30, binning._INT_RANGE
// the sort: 256 threads of 16 entries a tile, 8 bits a pass
constexpr int kSortItems = 16;
constexpr int kSortTile = kThreads * kSortItems;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
static_assert(kDigits == kThreads, "a thread per digit");

typedef unsigned long long u64;

struct Geom {
  int img_h, img_w, tile_h, tile_w, tiles_x, tiles_y;
  // 1 / tile_h and 1 / tile_w in float32: PyTorch divides a CUDA tensor by
  // a Python number as a product with its reciprocal
  float inv_tile_h, inv_tile_w;
};

struct Inputs {
  const float* ndc_x;
  const float* ndc_y;
  const float* view_z;
  const float* inv_a;
  const float* inv_b;
  const float* inv_c;
  const float* opacity;
  const unsigned char* valid;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.maximum / torch.minimum: NaN in either operand is the result
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}

// sqrt(clamp(x, min=0))
__device__ __forceinline__ float sqrt_pos(float x) {
  return __fsqrt_rn(x != x ? x : fmaxf(x, 0.0f));
}

// torch.clamp(x, -2^30, 2^30).to(int32) (binning._to_i32); the card's
// conversion takes NaN to 0, as PyTorch's does there
__device__ __forceinline__ int to_i32(float x) {
  if (x == x) x = fminf(fmaxf(x, -kIntRange), kIntRange);
  return static_cast<int>(x);
}

// torch.clamp(floor(x), 0, hi).to(int32) (binning._ellipse_tile_rect)
__device__ __forceinline__ int rect_edge(float x, int hi) {
  x = floorf(x);
  if (x == x) x = fminf(fmaxf(x, 0.0f), static_cast<float>(hi));
  return static_cast<int>(x);
}

__device__ __forceinline__ int clip_i(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// What a point's rows need, from binning._visible_and_safe,
// _ellipse_tile_rect and _y_span_in_xband (an invisible point has no rows
// and nothing else is read).
struct Point {
  float px, py, a, b, c, t, disc, dx, dy;
  int min_x, max_x, row_min, rows;
};

__device__ Point point_rows(const Inputs& in, int p, const Geom& g) {
  Point q;
  q.rows = 0;
  const float a = in.inv_a[p], b = in.inv_b[p], c = in.inv_c[p];
  const float disc = sub(mul(b, b), mul(a, c));
  const float nx = in.ndc_x[p], ny = in.ndc_y[p], op = in.opacity[p];
  // a Python number compared with a float32 tensor is cast to float32
  const bool visible = fabsf(nx) <= 1.3f && fabsf(ny) <= 1.3f &&
                       in.view_z[p] > 0.2f &&
                       op >= static_cast<float>(1.0 / 255.0) && a > 0.0f &&
                       c > 0.0f && disc < 0.0f && in.valid[p] != 0;
  if (!visible) return q;
  q.px = sub(mul(add(mul(nx, 0.5f), 0.5f), static_cast<float>(g.img_w)), 0.5f);
  q.py = sub(mul(add(mul(ny, 0.5f), 0.5f), static_cast<float>(g.img_h)), 0.5f);
  const float opc = op != op ? op : fmaxf(op, 1e-12f);
  q.t = mul(2.0f, logf(mul(opc, 255.0f)));
  q.a = a;
  q.b = b;
  q.c = c;
  q.disc = disc;
  q.dx = sqrt_pos(div(mul(-q.t, c), disc));
  q.dy = sqrt_pos(div(mul(-q.t, a), disc));
  const float tw = static_cast<float>(g.tile_w);
  const float th = static_cast<float>(g.tile_h);
  q.min_x = rect_edge(mul(sub(q.px, q.dx), g.inv_tile_w), g.tiles_x);
  q.max_x = rect_edge(mul(sub(add(add(q.px, q.dx), tw), 1.0f), g.inv_tile_w),
                      g.tiles_x);
  const int min_y = rect_edge(mul(sub(q.py, q.dy), g.inv_tile_h), g.tiles_y);
  const int max_y = rect_edge(
      mul(sub(add(add(q.py, q.dy), th), 1.0f), g.inv_tile_h), g.tiles_y);
  // the ellipse's y-extent within the rect's x-band
  const float x0 = mul(static_cast<float>(q.min_x), tw);
  const float x1 = mul(static_cast<float>(q.max_x), tw);
  const float e0 = tmin(tmax(sub(x0, q.px), -q.dx), q.dx);
  const float e1 = tmin(tmax(sub(x1, q.px), -q.dx), q.dx);
  const float e_ymin = mul(div(b, a), q.dy);
  const float ee_min = tmin(tmax(e_ymin, e0), e1);
  const float ee_max = tmin(tmax(-e_ymin, e0), e1);
  const float tc = mul(q.t, c);
  const float sq_min = sqrt_pos(add(mul(mul(disc, ee_min), ee_min), tc));
  const float sq_max = sqrt_pos(add(mul(mul(disc, ee_max), ee_max), tc));
  const float y_lo = add(q.py, div(sub(mul(-b, ee_min), sq_min), c));
  const float y_hi = add(q.py, div(add(mul(-b, ee_max), sq_max), c));
  q.row_min = clip_i(to_i32(floorf(mul(y_lo, g.inv_tile_h))), min_y, max_y);
  const int row_max =
      clip_i(to_i32(floorf(mul(y_hi, g.inv_tile_h))) + 1, min_y, max_y);
  if (q.max_x > q.min_x) q.rows = max(row_max - q.row_min, 0);
  return q;
}

// Row `row` of the point's exact x-span: its first tile column and its
// tile count (binning.tile_counts_for_rows).
__device__ __forceinline__ int row_span(const Point& q, int row,
                                        const Geom& g, int* count) {
  const float th = static_cast<float>(g.tile_h);
  const float rf = static_cast<float>(row);
  const float h0 = sub(mul(rf, th), q.py);
  const float h1 = sub(mul(add(rf, 1.0f), th), q.py);
  const float h0c = tmin(tmax(h0, -q.dy), q.dy);
  const float h1c = tmin(tmax(h1, -q.dy), q.dy);
  const float h_xmin = mul(div(q.b, q.c), q.dx);
  const float he_min = tmin(tmax(h_xmin, h0c), h1c);
  const float he_max = tmin(tmax(-h_xmin, h0c), h1c);
  const float ta = mul(q.t, q.a);
  const float sq_min = sqrt_pos(add(mul(mul(q.disc, he_min), he_min), ta));
  const float sq_max = sqrt_pos(add(mul(mul(q.disc, he_max), he_max), ta));
  const float x_lo = add(q.px, div(sub(mul(-q.b, he_min), sq_min), q.a));
  const float x_hi = add(q.px, div(add(mul(-q.b, he_max), sq_max), q.a));
  const int lo =
      clip_i(to_i32(floorf(mul(x_lo, g.inv_tile_w))), q.min_x, q.max_x);
  const int hi =
      clip_i(to_i32(floorf(mul(x_hi, g.inv_tile_w))) + 1, q.min_x, q.max_x);
  *count = max(hi - lo, 0);
  return lo;
}

// Every lane gets lane `src`'s point.
__device__ __forceinline__ Point shfl_point(const Point& q, int src) {
  Point r;
  r.px = __shfl_sync(kFullMask, q.px, src);
  r.py = __shfl_sync(kFullMask, q.py, src);
  r.a = __shfl_sync(kFullMask, q.a, src);
  r.b = __shfl_sync(kFullMask, q.b, src);
  r.c = __shfl_sync(kFullMask, q.c, src);
  r.t = __shfl_sync(kFullMask, q.t, src);
  r.disc = __shfl_sync(kFullMask, q.disc, src);
  r.dx = __shfl_sync(kFullMask, q.dx, src);
  r.dy = __shfl_sync(kFullMask, q.dy, src);
  r.min_x = __shfl_sync(kFullMask, q.min_x, src);
  r.max_x = __shfl_sync(kFullMask, q.max_x, src);
  r.row_min = __shfl_sync(kFullMask, q.row_min, src);
  r.rows = __shfl_sync(kFullMask, q.rows, src);
  return r;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFullMask, v, d);
  return v;
}

// ---------------------------------------------------------------------------
// bin_count_kernel: a grid-stride loop over the points (every thread of a
// block runs the same number of rounds, so a whole warp reaches each
// ballot).  Writes entries[p]; into totals, which the wrapper zeroed,
// adds the block's sums of the rows and entries ([0], [1]) and takes the
// largest of 0xffffffff - the view-z bits ([2]) and of the bits ([3]) over
// the points with entries.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) bin_count_kernel(
    Inputs in, Geom g, int m, int* __restrict__ entries,
    u64* __restrict__ totals) {
  __shared__ u64 s_sum[4][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 my_rows = 0, my_entries = 0;
  unsigned z_lo = 0, z_hi = 0;  // 0xffffffff - least bits, most bits
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads;
       base < m; base += static_cast<long long>(gridDim.x) * kThreads) {
    const int p = static_cast<int>(base) + threadIdx.x;
    Point q;
    q.rows = 0;
    if (p < m) q = point_rows(in, p, g);
    const bool is_long = q.rows > kLong;
    int n = 0;
    if (!is_long)
      for (int r = 0; r < q.rows; ++r) {
        int c;
        row_span(q, q.row_min + r, g, &c);
        n += c;
      }
    unsigned pending = __ballot_sync(kFullMask, is_long);
    while (pending) {
      const int src = __ffs(pending) - 1;
      pending &= pending - 1;
      const Point w = shfl_point(q, src);
      int part = 0;
      for (int r = lane; r < w.rows; r += 32) {
        int c;
        row_span(w, w.row_min + r, g, &c);
        part += c;
      }
      part = warp_sum(part);
      if (lane == src) n = part;
    }
    if (p < m) entries[p] = n;
    my_rows += q.rows;
    my_entries += n;
    if (n > 0) {
      const unsigned z = __float_as_uint(in.view_z[p]);
      z_lo = max(z_lo, 0xffffffffu - z);
      z_hi = max(z_hi, z);
    }
  }
  // the block's totals in 64 bits, its z range
  my_rows = warp_sum(my_rows);
  my_entries = warp_sum(my_entries);
  for (int d = 16; d; d >>= 1) {
    z_lo = max(z_lo, __shfl_xor_sync(kFullMask, z_lo, d));
    z_hi = max(z_hi, __shfl_xor_sync(kFullMask, z_hi, d));
  }
  if (lane == 0) {
    s_sum[0][warp] = my_rows;
    s_sum[1][warp] = my_entries;
    s_sum[2][warp] = z_lo;
    s_sum[3][warp] = z_hi;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int k = threadIdx.x;
    u64 s = 0;
    for (int w = 0; w < kThreads / 32; ++w)
      s = k < 2 ? s + s_sum[k][w] : max(s, s_sum[k][w]);
    if (s) {
      if (k < 2)
        atomicAdd(totals + k, s);
      else
        atomicMax(totals + k, s);
    }
  }
}

// ---------------------------------------------------------------------------
// bin_emit_kernel: point p's entries go to [ends[p] - entries[p], ends[p])
// (ends: the inclusive scan of the entry counts), row by row, each row's
// tiles left to right, each key tile << zb | (view-z bits - z_min).  A short point's thread writes them in a row; a long
// one's warp takes its rows 32 at a time: each lane spans one row, a
// shuffle scan gives the rows' offsets, and the lanes write the chunk's
// entries side by side, each finding its row by a binary search over the
// lanes' scanned counts.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) bin_emit_kernel(
    Inputs in, Geom g, int m, const int* __restrict__ entries,
    const int* __restrict__ ends, unsigned z_min, int zb,
    u64* __restrict__ keys, int* __restrict__ points) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  int n = 0, start = 0;
  if (p < m) {
    n = entries[p];
    start = ends[p] - n;
  }
  Point q;
  q.rows = 0;
  if (n > 0) q = point_rows(in, p, g);
  const bool is_long = n > kLong;
  if (!is_long && n > 0) {
    const u64 z = __float_as_uint(in.view_z[p]) - z_min;
    int o = start;
    for (int r = 0; r < q.rows; ++r) {
      const int y = q.row_min + r;
      int c;
      const int x0 = row_span(q, y, g, &c);
      const u64 t0 = static_cast<u64>(y * g.tiles_x + x0);
      for (int k = 0; k < c; ++k, ++o) {
        keys[o] = (t0 + k) << zb | z;
        points[o] = p;
      }
    }
  }
  unsigned pending = __ballot_sync(kFullMask, is_long);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const Point w = shfl_point(q, src);
    const int pt = __shfl_sync(kFullMask, p, src);
    int o = __shfl_sync(kFullMask, start, src);
    const u64 z = __float_as_uint(in.view_z[pt]) - z_min;
    for (int r0 = 0; r0 < w.rows; r0 += 32) {
      const int y = w.row_min + r0 + lane;
      int c = 0, x0 = 0;
      if (r0 + lane < w.rows) x0 = row_span(w, y, g, &c);
      // inclusive scan of the chunk's counts over the lanes
      int incl = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFullMask, incl, d);
        if (lane >= d) incl += v;
      }
      const int chunk = __shfl_sync(kFullMask, incl, 31);
      const int excl = incl - c;
      const int first = y * g.tiles_x + x0;  // the row's first tile
      // every lane runs every round, so the shuffles see the whole warp
      for (int k0 = 0; k0 < chunk; k0 += 32) {
        const int k = k0 + lane;
        // the row holding entry k: the number of lanes whose scan is <= k
        // (at most 31 while k < chunk)
        int row = 0;
        for (int s = 16; s; s >>= 1)
          if (__shfl_sync(kFullMask, incl, row + s - 1) <= k) row += s;
        const int t0 = __shfl_sync(kFullMask, first, row);
        const int e0 = __shfl_sync(kFullMask, excl, row);
        if (k < chunk) {
          keys[o + k] = static_cast<u64>(t0 + k - e0) << zb | z;
          points[o + k] = pt;
        }
      }
      o += chunk;
    }
  }
}

// ---------------------------------------------------------------------------
// bin_ranges_kernel: thread i in [0, E] looks at the boundary between
// sorted entries i - 1 and i, with tiles tp (-1 before the first) and tn
// (tiles_total past the last).  Where they differ, the tiles (tp, tn] start
// at i, and i ends tp's run and opens tn's: counts[tp] += i and counts[tn]
// -= i on the zeroed counts leave each tile its run's length.  Every tile
// lies in one such gap, so every start is written once.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) bin_ranges_kernel(
    const u64* __restrict__ keys, int e, int zb, int tiles_total,
    int* __restrict__ sorted_tile, int* __restrict__ tile_start,
    int* __restrict__ tile_count) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i > e) return;
  const int tp = i > 0 ? static_cast<int>(keys[i - 1] >> zb) : -1;
  const int tn = i < e ? static_cast<int>(keys[i] >> zb) : tiles_total;
  if (i < e) sorted_tile[i] = tn;
  if (tp == tn) return;
  const int at = static_cast<int>(i);
  for (int u = tp + 1; u <= tn && u < tiles_total; ++u) tile_start[u] = at;
  if (tp >= 0) atomicAdd(tile_count + tp, at);
  if (tn < tiles_total) atomicAdd(tile_count + tn, -at);
}

// ---------------------------------------------------------------------------
// bin_sort_count_kernel: the digit (bits [shift, shift + 8) of the key)
// histogram of each kSortTile-entry tile, digit-major: counts[d * nb + b]
// for tile b of nb, so that the inclusive scan of counts ends each
// (digit, tile) run where the stable scatter puts it.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) bin_sort_count_kernel(
    const u64* __restrict__ keys, int e, int shift, int nb,
    int* __restrict__ counts) {
  __shared__ int hist[kDigits];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kSortTile;
  const int n = static_cast<int>(min(static_cast<long long>(kSortTile),
                                     e - base));
  for (int j = threadIdx.x; j < n; j += kThreads)
    atomicAdd(hist + ((keys[base + j] >> shift) & (kDigits - 1)), 1);
  __syncthreads();
  counts[static_cast<long long>(threadIdx.x) * nb + blockIdx.x] =
      hist[threadIdx.x];
}

// ---------------------------------------------------------------------------
// bin_sort_scatter_kernel: tile b's pairs sorted stably by their digit in
// shared memory, then each written to its digit's run: the run of digit d
// in tile b starts at ends[d * nb + b] - counts[d * nb + b] and takes the
// tile's d-entries in order.  After the block sort thread t holds local
// ranks t, t + 256, ..., so neighbouring threads write neighbouring
// addresses within a run.  Entries past e load as all-ones keys, which
// sort behind every real entry of the tile and are not written.  Two
// blocks an SM (at most 128 registers a thread) hide more of the scatter's
// latency than one of 150 registers: 2.04 against 2.48 ms for 20M pairs
// of 38 bits on the H100.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 2) bin_sort_scatter_kernel(
    const u64* __restrict__ keys_in, const int* __restrict__ vals_in,
    int e, int shift, int nb, const int* __restrict__ counts,
    const int* __restrict__ ends, u64* __restrict__ keys_out,
    int* __restrict__ vals_out) {
  typedef cub::BlockLoad<u64, kThreads, kSortItems,
                         cub::BLOCK_LOAD_TRANSPOSE> LoadKeys;
  typedef cub::BlockLoad<int, kThreads, kSortItems,
                         cub::BLOCK_LOAD_TRANSPOSE> LoadVals;
  typedef cub::BlockScan<int, kThreads> Scan;
  typedef cub::BlockRadixSort<u64, kThreads, kSortItems, int> Sort;
  __shared__ union {
    typename LoadKeys::TempStorage keys;
    typename LoadVals::TempStorage vals;
    typename Scan::TempStorage scan;
    typename Sort::TempStorage sort;
  } tmp;
  __shared__ int s_first[kDigits];  // run start less the first local rank
  const long long base = static_cast<long long>(blockIdx.x) * kSortTile;
  const int n = static_cast<int>(min(static_cast<long long>(kSortTile),
                                     e - base));
  u64 k[kSortItems];
  int v[kSortItems];
  LoadKeys(tmp.keys).Load(keys_in + base, k, n, ~0ULL);
  __syncthreads();
  LoadVals(tmp.vals).Load(vals_in + base, v, n, 0);
  __syncthreads();
  // the tile's digit runs: local start (a block scan over the digits) and
  // global start
  const long long at = static_cast<long long>(threadIdx.x) * nb + blockIdx.x;
  const int c = counts[at];
  int local;
  Scan(tmp.scan).ExclusiveSum(c, local);
  s_first[threadIdx.x] = ends[at] - c - local;
  __syncthreads();
  Sort(tmp.sort).SortBlockedToStriped(k, v, shift, shift + kDigitBits);
  for (int j = 0; j < kSortItems; ++j) {
    const int r = j * kThreads + threadIdx.x;
    if (r < n) {
      const int pos = s_first[(k[j] >> shift) & (kDigits - 1)] + r;
      keys_out[pos] = k[j];
      vals_out[pos] = v[j];
    }
  }
}

int count_grid(int m) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  const long long blocks = (static_cast<long long>(m) + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

Geom make_geom(int img_h, int img_w, int tile_h, int tile_w) {
  Geom g;
  g.img_h = img_h;
  g.img_w = img_w;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.tiles_x = (img_w + tile_w - 1) / tile_w;
  g.tiles_y = (img_h + tile_h - 1) / tile_h;
  g.inv_tile_h = 1.0f / static_cast<float>(tile_h);
  g.inv_tile_w = 1.0f / static_cast<float>(tile_w);
  return g;
}

bool geom_ok(int m, int img_h, int img_w, int tile_h, int tile_w) {
  return m > 0 && img_h > 0 && img_w > 0 && tile_h > 0 && tile_w > 0;
}

Inputs make_inputs(const void* const* in) {
  return Inputs{static_cast<const float*>(in[0]),
                static_cast<const float*>(in[1]),
                static_cast<const float*>(in[2]),
                static_cast<const float*>(in[3]),
                static_cast<const float*>(in[4]),
                static_cast<const float*>(in[5]),
                static_cast<const float*>(in[6]),
                static_cast<const unsigned char*>(in[7])};
}

}  // namespace

// `inputs` points to eight device pointers: ndc x, ndc y, view z, the
// inverse covariance's a, b, c, opacity (float32 [m] each) and valid
// (bool [m]).
extern "C" int litegs_bin_count(const void* const* inputs, int m, int img_h,
                                int img_w, int tile_h, int tile_w,
                                void* entries, void* totals, void* stream) {
  if (!geom_ok(m, img_h, img_w, tile_h, tile_w))
    return static_cast<int>(cudaErrorInvalidValue);
  bin_count_kernel<<<count_grid(m), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      make_inputs(inputs), make_geom(img_h, img_w, tile_h, tile_w), m,
      static_cast<int*>(entries), static_cast<u64*>(totals));
  return static_cast<int>(cudaGetLastError());
}

// z_min: the least view-z bits of an emitting point; zb: the bit width of
// the largest less the least.
extern "C" int litegs_bin_emit(const void* const* inputs, int m, int img_h,
                               int img_w, int tile_h, int tile_w,
                               const void* entries, const void* ends,
                               unsigned z_min, int zb, void* keys,
                               void* points, void* stream) {
  if (!geom_ok(m, img_h, img_w, tile_h, tile_w) || zb < 0 || zb > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  bin_emit_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      make_inputs(inputs), make_geom(img_h, img_w, tile_h, tile_w), m,
      static_cast<const int*>(entries), static_cast<const int*>(ends), z_min,
      zb, static_cast<u64*>(keys), static_cast<int*>(points));
  return static_cast<int>(cudaGetLastError());
}

// One pass of the sort over bits [shift, shift + 8): counts and ends hold
// kDigits * nb ints, nb = ceil(e / kSortTile).
extern "C" int litegs_bin_sort_count(const void* keys, int e, int shift,
                                     void* counts, void* stream) {
  if (e <= 0 || shift < 0 || shift > 56)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (e + kSortTile - 1) / kSortTile;
  bin_sort_count_kernel<<<nb, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(keys), e, shift, nb, static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int litegs_bin_sort_scatter(const void* keys_in,
                                       const void* vals_in, int e, int shift,
                                       const void* counts, const void* ends,
                                       void* keys_out, void* vals_out,
                                       void* stream) {
  if (e <= 0 || shift < 0 || shift > 56)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (e + kSortTile - 1) / kSortTile;
  bin_sort_scatter_kernel<<<nb, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(keys_in), static_cast<const int*>(vals_in), e,
      shift, nb, static_cast<const int*>(counts),
      static_cast<const int*>(ends), static_cast<u64*>(keys_out),
      static_cast<int*>(vals_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int litegs_bin_ranges(const void* keys, int e, int zb,
                                 int tiles_total, void* sorted_tile,
                                 void* tile_start, void* tile_count,
                                 void* stream) {
  if (e <= 0 || tiles_total <= 0 || zb < 0 || zb > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(e) + 1;
  bin_ranges_kernel<<<static_cast<int>((threads + kThreads - 1) / kThreads),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(keys), e, zb, tiles_total,
      static_cast<int*>(sorted_tile), static_cast<int*>(tile_start),
      static_cast<int*>(tile_count));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* litegs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
