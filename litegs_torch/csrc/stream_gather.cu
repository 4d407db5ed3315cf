// Streaming expansion and block-gather kernels for Hopper (sm_90a).
//
// Replace the four Pallas kernels of litegs_tpu/ops/stream_gather.py:
//
//   expand_prefix_kernel        <- _expand_kernel      (expand_attrs)
//   expand_window_kernel        <- _expand_kernel_w    (expand_attrs_windowed)
//   expand_window_async_kernel  <- _expand_kernel_dma  (expand_attrs_windowed,
//                                                       dma=True)
//   gather_blocks_kernel        <- _monotonic_kernel   (gather_blocks)
//
// An expansion replicates per-item attribute rows attrs [A, S] into flat
// slots: item i owns the counts[i] slots that begin at starts[i] (the
// exclusive prefix sum of counts), and slot e of its owner is at rank
// e - starts[owner].  This is the emit half of the reference's prefix-sum +
// emit (duplicate_with_keys, binning.cu:33-110).  The prefix kernel takes
// starts and counts from its wrapper; the two window kernels take the
// inclusive prefix sum (int64) as torch.cumsum gives it, find their steps'
// owners and apply the window check themselves.
//
// All four kernels copy 4-byte words and never interpret them, so a row may
// hold float32 or int32 values.  They are bound by bytes: every output word
// is written once ((A + 1) * 4 * L bytes for L slots) and the payload is
// read once from device memory; the decode is a handful of integer
// operations per slot, and there is no multiply-accumulate for the tensor
// cores to take.  The designs keep writes coalesced along slots and the
// re-reads of an item's attributes in cache or shared memory.
//
// What the TPU kernels did to avoid a gather (the compare-matrix owner
// decode, one-vreg lane gathers, the MXU identity transpose, starts encoded
// as f32 values, 128-aligned pads with INT_BIG sentinels) has no
// counterpart here.
#include <cuda_runtime.h>
#include <cuda_pipeline_primitives.h>

#include <climits>
#include <cstdint>

namespace {

typedef unsigned int word;  // one 4-byte payload word, float32 or int32 bits

constexpr int kBlk = 128;       // item-window alignment, gather run width
constexpr int kThreads = 256;   // threads per block of the expansion kernels
constexpr int kLongItem = 32;   // above this count a warp shares the item
constexpr unsigned kFullMask = 0xffffffffu;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 232448;  // 227 KB, the most a block can opt in to

// ---------------------------------------------------------------------------
// expand_prefix_kernel: item-driven.  One thread per item writes the item's
// slots of every row and their ranks 0 .. count-1; an item with more than
// kLongItem slots is instead shared by its warp, so a point covering
// hundreds of tile rows does not serialise one thread.  Neighbouring items
// own neighbouring slots, so a warp's writes stay close together.  Slots
// that no item owns (past the total) are not written.
// ---------------------------------------------------------------------------
__global__ void expand_prefix_kernel(
    const word* __restrict__ attrs,   // [A, S]
    const int* __restrict__ starts,   // [S] exclusive prefix sum of counts
    const int* __restrict__ counts,   // [S]
    word* __restrict__ out,           // [A, L]
    int* __restrict__ rank,           // [L]
    int a_rows, int s, int out_len) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  int start = 0, count = 0;
  if (item < s) {
    start = starts[item];
    count = counts[item];
  }
  // keep the item's run inside [0, L)
  if (count < 0 || start < 0 || start >= out_len)
    count = 0;
  else
    count = min(count, out_len - start);

  const bool is_long = count > kLongItem;
  if (!is_long && count > 0) {
    for (int r = 0; r < count; ++r) rank[start + r] = r;
    for (int a = 0; a < a_rows; ++a) {
      const word v = attrs[static_cast<size_t>(a) * s + item];
      word* dst = out + static_cast<size_t>(a) * out_len + start;
      for (int r = 0; r < count; ++r) dst[r] = v;
    }
  }
  // every thread of the warp reaches the ballot: none returned early
  unsigned pending = __ballot_sync(kFullMask, is_long);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const int st = __shfl_sync(kFullMask, start, src);
    const int cn = __shfl_sync(kFullMask, count, src);
    const int it = __shfl_sync(kFullMask, item, src);
    for (int r = lane; r < cn; r += 32) rank[st + r] = r;
    for (int a = 0; a < a_rows; ++a) {
      const word v = attrs[static_cast<size_t>(a) * s + it];
      word* dst = out + static_cast<size_t>(a) * out_len + st;
      for (int r = lane; r < cn; r += 32) dst[r] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// The plan of an output step, shared by both window kernels.  The owner of
// slot q is the first item i with cum[i] > q (cum: the inclusive prefix sum
// of the counts as torch.cumsum gives it, int64), clamped to the last item
// -- owner_of_slots of both packages.  Each block finds the owner lo of its
// step's first slot itself and applies the window check of
// litegs_tpu/ops/stream_gather.py:223-238: the owners lo and hi of the
// step's first and last slot, the queries clamped to [0, total - 1], must
// satisfy hi - lo <= window_items.  hi lies there iff the window reaches
// the last item or its last item ends past the query: one load.  A step
// that fails clears the wrapper's ok byte and writes nothing.
// ---------------------------------------------------------------------------

// owner(q) for the whole block; every thread returns the same value.  In
// each round the 32 lanes of warp 0 probe 32 points spread evenly over the
// range left and a ballot counts those <= q (one warp's probes: each is a
// scattered 8-byte read that costs its own 32-byte sector); once at most
// blockDim.x items are left the block counts them.  Three rounds narrow
// 2.5M items to about 70.  Ends with a barrier.
__device__ int owner_search(const long long* __restrict__ cum, int s,
                            long long q, int* s_ab) {
  // the first i with cum[i] > q (s: none) is in [a, b]
  int a = 0, b = s;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    while (b - a > static_cast<int>(blockDim.x)) {
      const long long w = b - a;
      const int c = __popc(__ballot_sync(
          kFullMask, __ldg(cum + a + (lane + 1) * w / 33) <= q));
      const int a0 = a;
      if (c < 32) b = a0 + static_cast<int>((c + 1) * w / 33);
      if (c > 0) a = a0 + static_cast<int>(c * w / 33) + 1;
    }
    if (lane == 0) {
      s_ab[0] = a;
      s_ab[1] = b;
    }
  }
  __syncthreads();
  a = s_ab[0];
  b = s_ab[1];
  const int t = threadIdx.x;
  const int c = __syncthreads_count(a + t < b && __ldg(cum + a + t) <= q);
  return min(a + c, s - 1);
}

// lo for step s0 of the block, or -1 (every thread alike) when the step
// fails the window check, after clearing ok.
__device__ int step_plan(const long long* __restrict__ cum, int s,
                         long long s0, int window_items, int slots_per_step,
                         unsigned char* ok, int* s_ab) {
  const long long last_live = max(__ldg(cum + s - 1) - 1, 0LL);
  const long long q1 = min(s0 + slots_per_step - 1, last_live);
  const int lo = owner_search(cum, s, min(s0, last_live), s_ab);
  const long long far = static_cast<long long>(lo) + window_items;
  if (far >= s - 1 || __ldg(cum + far) > q1) return lo;
  if (threadIdx.x == 0) *ok = 0;
  return -1;
}

__device__ __forceinline__ int clamp_int(long long v) {
  return static_cast<int>(min(v, static_cast<long long>(INT_MAX)));
}

// The starts of the window's items [w0, w0 + window) into s_starts, int32
// from the prefix sum, INT_MAX past the last item.
__device__ __forceinline__ void stage_starts(
    const long long* __restrict__ cum, int s, int w0, int window,
    int* s_starts) {
  for (int j = threadIdx.x; j < window; j += blockDim.x) {
    const long long i = static_cast<long long>(w0) + j;
    s_starts[j] = i >= s ? INT_MAX : i > 0 ? clamp_int(__ldg(cum + i - 1)) : 0;
  }
}

// Number of window starts <= slot.  The starts are non-decreasing (the pads
// past the last item are INT_MAX), so the last start <= slot belongs to the
// slot's owner: items with a zero count share their start with the next
// item and are skipped.
__device__ __forceinline__ int count_leq(const int* s_starts, int window,
                                         int slot) {
  int lo = 0, hi = window;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_starts[mid] <= slot)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// expand_window_kernel: slot-driven, one block per step of slots_per_step
// output slots.  The block plans its step (step_plan), loads the starts of
// the window of window = window_items + 128 items anchored at
// floor(lo / 128) * 128 -- which holds every owner of the step when the
// check passes -- into shared memory, and each thread binary-searches its
// slot's owner there and copies the owner's attribute words from device
// memory (neighbouring slots read the same or neighbouring items, so the
// reads hit in L1) into the slot, coalesced along slots.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) expand_window_kernel(
    const word* __restrict__ attrs,     // [A, S]
    const long long* __restrict__ cum,  // [S] inclusive prefix sum
    word* __restrict__ out,             // [A, L]
    int* __restrict__ rank,             // [L]
    unsigned char* __restrict__ ok,     // 1 from the wrapper, 0 on overrun
    int a_rows, int s, int out_len, int window_items, int slots_per_step) {
  extern __shared__ int s_starts[];  // [window]
  __shared__ int s_ab[2];
  const int window = window_items + kBlk;
  const long long s0 = static_cast<long long>(blockIdx.x) * slots_per_step;
  const int lo = step_plan(cum, s, s0, window_items, slots_per_step, ok, s_ab);
  if (lo < 0) return;  // uniform
  const int w0 = (lo / kBlk) * kBlk;
  stage_starts(cum, s, w0, window, s_starts);
  __syncthreads();
  const int n = static_cast<int>(
      min(static_cast<long long>(slots_per_step), out_len - s0));
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int slot = static_cast<int>(s0) + k;
    const int cnt = count_leq(s_starts, window, slot);
    const int local = max(cnt - 1, 0);
    const int start_at = cnt > 0 ? s_starts[local] : -1;
    rank[slot] = slot - start_at;
    const size_t src = static_cast<size_t>(w0) + local;
    for (int a = 0; a < a_rows; ++a)
      out[static_cast<size_t>(a) * out_len + slot] =
          __ldg(attrs + static_cast<size_t>(a) * s + src);
  }
}

// ---------------------------------------------------------------------------
// expand_window_async_kernel: expand_window_kernel's contract (the same
// out, rank, total and window check), redesigned around shared memory and
// asynchronous copies.  One block of the old design staged the whole
// window_items + 128 window of a step, starts and attributes, after a
// search of three rounds of dependent loads, and then had nothing to
// overlap them with.  Here:
//
// - Persistent blocks, each over a contiguous range of steps (the grid is
//   the card's SMs times the blocks one SM holds).  A block searches the
//   owner of its first step's first slot once (owner_search); every later
//   step's first owner falls out of the previous step's plan.
// - The plan of a step reads the prefix sum from its first owner lo on,
//   512 items a round (four coalesced loads of each of the block's 128
//   threads, loaded a step ahead; one round for a step whose owners span
//   fewer items), and counts the items ending at or before the step's last
//   slot and the next step's first: that gives hi, the owner of the last
//   slot, and the next step's lo.  The window check is hi - lo <=
//   window_items, as in expand_window_kernel; a step that fails clears ok
//   and writes nothing.
// - Only the owned items [lo, hi] are staged: their ends (the inclusive
//   prefix sum as int32) from the plan's loads, their attribute words by
//   cp.async, 16 bytes a copy when S is a multiple of 4 and attrs 16-byte
//   aligned, else 4.  A ring of two stages: step b + 1's copies and step
//   b + 2's prefix-sum loads are in flight while step b is decoded and
//   written out.
// - The decode searches only the step's own ends (about 200-300 items at
//   binning's shapes, not the window's 640-896), once per 4 slots, into a
//   shared owner map of the step.  The write-out walks every row of out
//   and the rank row with 16-byte stores on the 16-byte-aligned body of
//   each row's run and 4-byte stores at its ends.
//
// Slots past the total belong to the item that owns the last live slot:
// their rank counts on from its start (the contract leaves them
// arbitrary; stream_gather.window_block_plain models them).  The kernel
// moves bytes and does no arithmetic that tensor cores could take.
// ---------------------------------------------------------------------------
constexpr int kAsyncThreads = 128;
constexpr int kAsyncLoads = 4;  // items a thread reads in a planning round
constexpr int kAsyncRound = kAsyncLoads * kAsyncThreads;

// Words of one stage: the ends of up to cap items, then [A, cap] attribute
// words, cap = window_items + 8 (a passing step owns at most
// window_items + 1 items, staged from lo rounded down to 4).
__host__ __device__ inline int async_cap(int window_items) {
  return window_items + 8;
}

struct AsyncPlan {
  int lo;    // owner of the step's first slot
  int hi;    // owner of its last live slot; -1: the window check failed
  int next;  // owner of the next step's first slot
};

// The prefix sums a step's plan reads first: cum[lo - 1] (thread 0) and
// the first round's kAsyncLoads items of each thread.  Loaded a step
// ahead, so that they are in flight while the block writes out the step
// before.
struct AsyncLoads {
  long long start;  // cum[lo - 1], or 0
  long long v[kAsyncLoads];  // cum[lo + t + u * kAsyncThreads]; past S: max
};

__device__ __forceinline__ AsyncLoads async_load(
    const long long* __restrict__ cum, int s, int lo) {
  AsyncLoads l;
  l.start = threadIdx.x == 0 && lo > 0 ? __ldg(cum + lo - 1) : 0;
#pragma unroll
  for (int u = 0; u < kAsyncLoads; ++u) {
    const int i = lo + threadIdx.x + u * kAsyncThreads;
    l.v[u] = i < s ? __ldg(cum + i) : LLONG_MAX;
  }
  return l;
}

// Plans step s0 / slots_per_step from its first owner lo and the loads
// async_load made there; writes the ends of the items from lo on into
// ends[0, cap) and the start of lo into *start_lo.  Every thread returns
// the same plan.
__device__ AsyncPlan async_plan(const long long* __restrict__ cum, int s,
                                long long last_live, long long s0,
                                int slots_per_step, int window_items, int lo,
                                const AsyncLoads& first, int* ends,
                                int* start_lo, bool want_next,
                                unsigned char* ok, int* s_ab,
                                unsigned (*s_count)[kAsyncThreads / 32],
                                int& round) {
  const long long q1 = min(s0 + slots_per_step - 1, last_live);
  const long long qn = min(s0 + slots_per_step, last_live);
  const int cap = async_cap(window_items);
  if (threadIdx.x == 0) *start_lo = clamp_int(first.start);
  AsyncPlan plan{lo, -1, -1};
  // cum[i] <= q for a prefix of the items from lo on (cum does not
  // decrease), so a count over the round is the position of the first
  // item past q
  for (int base = lo;; base += kAsyncRound) {
    const int len = min(kAsyncRound, s - base);
    // per warp: the items ending at or before q1 in the low half, qn in
    // the high half; one barrier, and the round's parity keeps a slow
    // reader's sums from the next round's writers
    unsigned count = 0;
#pragma unroll
    for (int u = 0; u < kAsyncLoads; ++u) {
      const int j = threadIdx.x + u * kAsyncThreads;
      long long v = first.v[u];
      if (base != lo) v = j < len ? __ldg(cum + base + j) : LLONG_MAX;
      if (j < len && base + j - lo < cap) ends[base + j - lo] = clamp_int(v);
      count += __popc(__ballot_sync(kFullMask, v <= q1)) +
               (__popc(__ballot_sync(kFullMask, v <= qn)) << 16);
    }
    unsigned* sums = s_count[round & 1];
    ++round;
    if ((threadIdx.x & 31) == 0) sums[threadIdx.x >> 5] = count;
    __syncthreads();
    count = 0;
#pragma unroll
    for (int w = 0; w < kAsyncThreads / 32; ++w) count += sums[w];
    const int n1 = static_cast<int>(count & 0xffffu);
    const int nn = static_cast<int>(count >> 16);
    if (plan.next < 0 && nn < len) plan.next = base + nn;
    if (n1 < len) {
      plan.hi = base + n1;
      break;
    }
    if (base + len >= s) {  // no item ends past q1: every count is zero
      plan.hi = s - 1;
      if (plan.next < 0) plan.next = s - 1;
      break;
    }
    if (base + len > lo + window_items) break;  // hi lies past the window
  }
  if (plan.hi >= 0 && plan.hi - lo > window_items) plan.hi = -1;
  if (plan.hi < 0 && threadIdx.x == 0) *ok = 0;
  if (want_next && plan.next < 0) plan.next = owner_search(cum, s, qn, s_ab);
  return plan;
}

// cp.async copies of the attribute words of items [first, hi], first = lo
// rounded down to VEC, into tile [A, cap].
template <int VEC>
__device__ __forceinline__ void async_stage(const word* __restrict__ attrs,
                                            int a_rows, int s, int lo,
                                            int hi, int cap, word* tile) {
  const int first = lo & ~(VEC - 1);
  const int chunks = (hi - first) / VEC + 1;
  for (int c = threadIdx.x; c < a_rows * chunks; c += blockDim.x) {
    const int row = c / chunks;
    const int j = (c - row * chunks) * VEC;
    __pipeline_memcpy_async(tile + static_cast<size_t>(row) * cap + j,
                            attrs + static_cast<size_t>(row) * s + first + j,
                            VEC * sizeof(word));
  }
}

// Decode step s0's n slots into map (each slot's owner, local to lo) and rk
// (its rank).  A thread takes 4 neighbouring slots: a binary search among
// the step's own ends (the first item ending past the slot, clamped to the
// last live slot) for the first, then a walk forward for the others.
// Ends with a barrier.
__device__ void async_decode(const AsyncPlan& plan, const int* ends,
                             int start_lo, long long s0, int n,
                             long long last_live, int* map, int* rk) {
  const int span = plan.hi - plan.lo + 1;
  for (int k0 = 4 * threadIdx.x; k0 < n; k0 += 4 * blockDim.x) {
    long long q = min(s0 + k0, last_live);
    int a = 0, b = span - 1;  // the owner lies in [a, b]: span - 1 clamps
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (ends[mid] <= q)
        a = mid + 1;
      else
        b = mid;
    }
    for (int k = k0; k < min(k0 + 4, n); ++k) {
      q = min(s0 + k, last_live);
      while (a < span - 1 && ends[a] <= q) ++a;
      map[k] = a;
      rk[k] = static_cast<int>(s0 + k) - (a > 0 ? ends[a - 1] : start_lo);
    }
  }
  __syncthreads();
}

// Write step s0's n slots: rows 0 .. A - 1 of out through map from the
// stage's words of item lo on (row r at src0 + r * stride), then rank from
// rk.  A row's run of n words gets 4-byte stores up to its first 16-byte
// boundary, 16-byte stores over its body and 4-byte stores over the rest;
// the block's threads walk the (row, unit) pairs row by row.
__device__ void async_store(const word* src0, size_t stride, int a_rows,
                            long long s0, int n, int out_len, word* out,
                            int* rank, const int* map, const int* rk) {
  const int units = n / 4 + 6;  // at least a row's units, at any alignment
  int row = 0, unit = threadIdx.x;
  while (unit >= units) {
    unit -= units;
    ++row;
  }
  while (row <= a_rows) {
    const bool is_rank = row == a_rows;
    word* dst = is_rank ? reinterpret_cast<word*>(rank) + s0
                        : out + static_cast<size_t>(row) * out_len + s0;
    const int head = min(
        n, static_cast<int>(-(reinterpret_cast<uintptr_t>(dst) >> 2) & 3));
    const int body = (n - head) >> 2;
    const int tail_at = head + 4 * body;
    // the words of the row: tile[row][map[k]], or rk[k]
    const word* src = is_rank ? reinterpret_cast<const word*>(rk)
                              : src0 + row * stride;
    const int* idx = is_rank ? nullptr : map;
    if (unit < body) {
      const int k = head + 4 * unit;
      uint4 v;
      v.x = src[idx ? idx[k] : k];
      v.y = src[idx ? idx[k + 1] : k + 1];
      v.z = src[idx ? idx[k + 2] : k + 2];
      v.w = src[idx ? idx[k + 3] : k + 3];
      *reinterpret_cast<uint4*>(dst + k) = v;
    } else if (unit < body + head + (n - tail_at)) {
      const int j = unit - body;
      const int k = j < head ? j : tail_at + (j - head);
      dst[k] = src[idx ? idx[k] : k];
    }
    unit += blockDim.x;
    while (unit >= units) {
      unit -= units;
      ++row;
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kAsyncThreads) expand_window_async_kernel(
    const word* __restrict__ attrs,     // [A, S]
    const long long* __restrict__ cum,  // [S] inclusive prefix sum
    word* __restrict__ out,             // [A, L]
    int* __restrict__ rank,             // [L]
    unsigned char* __restrict__ ok,     // 1 from the wrapper, 0 on overrun
    int a_rows, int s, int out_len, int window_items, int slots_per_step) {
  // two stages of [cap] ends + [A, cap] attribute words, then the owner
  // map and the ranks of one step
  extern __shared__ __align__(16) word smem[];
  __shared__ int s_ab[2];
  __shared__ int s_start[2];
  __shared__ unsigned s_count[2][kAsyncThreads / 32];
  int round = 0;  // planning rounds so far (s_count's parity)
  const int cap = async_cap(window_items);
  const int stage_words = (a_rows + 1) * cap;
  int* map = reinterpret_cast<int*>(smem + 2 * stage_words);
  int* rk = map + slots_per_step;
  const long long steps =
      (static_cast<long long>(out_len) + slots_per_step - 1) / slots_per_step;
  const int b0 = static_cast<int>(steps * blockIdx.x / gridDim.x);
  const int b1 = static_cast<int>(steps * (blockIdx.x + 1) / gridDim.x);
  if (b0 >= b1) return;  // uniform
  const long long last_live = max(__ldg(cum + s - 1) - 1, 0LL);
  auto ends_of = [&](int p) {
    return reinterpret_cast<int*>(smem + p * stage_words);
  };
  auto tile_of = [&](int p) { return smem + p * stage_words + cap; };

  // Steps b and b + 1 are planned and their copies in flight when
  // iteration b begins; it loads the prefix sums of step b + 2, writes
  // out step b, and then plans step b + 2 into step b's stage.
  auto plan_step = [&](int b, int lo, int p) {
    const long long s0 = static_cast<long long>(b) * slots_per_step;
    return async_plan(cum, s, last_live, s0, slots_per_step, window_items,
                      lo, async_load(cum, s, lo), ends_of(p), &s_start[p],
                      b + 1 < b1, ok, s_ab, s_count, round);
  };
  // one commit group per step, empty for a step that failed its check or
  // lies past the block's range
  auto stage_step = [&](const AsyncPlan& plan, int p, bool live) {
    if (live && plan.hi >= 0)
      async_stage<VEC>(attrs, a_rows, s, plan.lo, plan.hi, cap, tile_of(p));
    __pipeline_commit();
  };
  const int lo = owner_search(
      cum, s, min(static_cast<long long>(b0) * slots_per_step, last_live),
      s_ab);
  AsyncPlan cur = plan_step(b0, lo, 0);
  stage_step(cur, 0, true);
  AsyncPlan nxt = cur;
  if (b0 + 1 < b1) nxt = plan_step(b0 + 1, cur.next, 1);
  stage_step(nxt, 1, b0 + 1 < b1);
  for (int b = b0; b < b1; ++b) {
    const int p = (b - b0) & 1;
    const bool ahead = b + 2 < b1;
    AsyncLoads loads{};
    if (ahead) loads = async_load(cum, s, nxt.next);
    __pipeline_wait_prior(1);  // step b's copies have landed
    __syncthreads();
    const long long s0 = static_cast<long long>(b) * slots_per_step;
    if (cur.hi >= 0) {  // uniform
      const int n = static_cast<int>(
          min(static_cast<long long>(slots_per_step), out_len - s0));
      async_decode(cur, ends_of(p), s_start[p], s0, n, last_live, map, rk);
      async_store(tile_of(p) + (cur.lo & (VEC - 1)), cap, a_rows, s0, n,
                  out_len, out, rank, map, rk);
    }
    __syncthreads();  // stage p and the map are free again
    AsyncPlan after = nxt;
    if (ahead)
      after = async_plan(cum, s, last_live, s0 + 2 * slots_per_step,
                         slots_per_step, window_items, nxt.next, loads,
                         ends_of(p), &s_start[p], b + 3 < b1, ok, s_ab,
                         s_count, round);
    stage_step(after, p, ahead);
    cur = nxt;
    nxt = after;
  }
}

// ---------------------------------------------------------------------------
// gather_blocks_kernel: out[:, 128 b + j] = attrs[:, clip(src_lo[b], 0,
// S - 1) + j], zero past S.  Bound by bytes: the runs are read once and
// written once.  Each warp moves whole runs, lane l words 4l .. 4l + 3 of
// every row with one 16-byte store (out's runs start every 512 bytes); its
// loads are four 4-byte loads, since the source run starts anywhere, and a
// warp's together cover the run's 512 bytes.  The grid is persistent (the
// card's SMs times the blocks one holds) and a warp keeps kRunsInFlight
// runs in flight, so an SM has tens of kilobytes of loads outstanding even
// at A = 1.  src_lo is read as given, int32 or int64, and clamped here.
// No arithmetic for tensor cores.
// ---------------------------------------------------------------------------
constexpr int kGatherThreads = 256;
constexpr int kRunsInFlight = 2;

__device__ __forceinline__ word word_or_zero(const word* __restrict__ row,
                                             long long i, int s) {
  return i < s ? __ldg(row + i) : 0u;
}

template <typename Index>
__global__ void __launch_bounds__(kGatherThreads) gather_blocks_kernel(
    const word* __restrict__ attrs,     // [A, S]
    const Index* __restrict__ src_lo,   // [nb]
    word* __restrict__ out,             // [A, nb * 128]
    int a_rows, int s, int nb) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const size_t out_len = static_cast<size_t>(nb) * kBlk;
  for (int b = warp; b < nb; b += kRunsInFlight * warps) {
    long long lo[kRunsInFlight];
#pragma unroll
    for (int r = 0; r < kRunsInFlight; ++r) {
      const int br = b + r * warps;
      const long long v = br < nb ? static_cast<long long>(src_lo[br]) : 0;
      lo[r] = min(max(v, 0LL), static_cast<long long>(s) - 1) + 4 * lane;
    }
    // rows one at a time: unrolled, the rows' loads cost registers and
    // blocks per SM
#pragma unroll 1
    for (int a = 0; a < a_rows; ++a) {
      const word* row = attrs + static_cast<size_t>(a) * s;
      uint4 v[kRunsInFlight];
#pragma unroll
      for (int r = 0; r < kRunsInFlight; ++r)
        v[r] = make_uint4(word_or_zero(row, lo[r], s),
                          word_or_zero(row, lo[r] + 1, s),
                          word_or_zero(row, lo[r] + 2, s),
                          word_or_zero(row, lo[r] + 3, s));
#pragma unroll
      for (int r = 0; r < kRunsInFlight; ++r) {
        const int br = b + r * warps;
        if (br < nb)
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(a) * out_len +
                                    static_cast<size_t>(br) * kBlk +
                                    4 * lane) = v[r];
      }
    }
  }
}

inline int steps_of(int out_len, int slots_per_step) {
  return (out_len + slots_per_step - 1) / slots_per_step;
}

inline bool window_args_ok(int a_rows, int s, int out_len, int window_items,
                           int slots_per_step) {
  return a_rows >= 0 && s > 0 && out_len > 0 && window_items > 0 &&
         window_items % kBlk == 0 && slots_per_step > 0;
}

// Dynamic shared memory of expand_window_kernel's block: the window's
// starts.
inline size_t window_smem(int window_items) {
  return static_cast<size_t>(window_items + kBlk) * sizeof(word);
}

// ... and of expand_window_async_kernel's: two stages of ends and
// attribute words, and the owner map and ranks of one step.
inline size_t async_smem(int a_rows, int window_items, int slots_per_step) {
  return (2 * static_cast<size_t>(a_rows + 1) * async_cap(window_items) +
          2 * static_cast<size_t>(slots_per_step)) *
         sizeof(word);
}

// Let `kernel` take `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Blocks of a persistent grid over `work` units: the SMs of the current
// device times the blocks of `threads` threads and `smem` bytes that one
// SM holds, at most `work`.  The last answer is kept, so a launch does not
// ask the runtime again for the same kernel, device and size.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                            long long work, int* grid) {
  struct Key {
    const void* fn;
    int dev, threads;
    size_t smem;
  };
  static Key last{nullptr, -1, 0, 0};
  static long long last_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  if (last.fn != fn || last.dev != dev || last.threads != threads ||
      last.smem != smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    last = Key{fn, dev, threads, smem};
    last_blocks = static_cast<long long>(sms) * per_sm;
  }
  *grid = static_cast<int>(work < last_blocks ? work : last_blocks);
  return cudaSuccess;
}

}  // namespace

extern "C" int litegs_expand_prefix(
    const void* attrs, const void* starts, const void* counts, void* out,
    void* rank, int a_rows, int s, int out_len, void* stream) {
  if (a_rows <= 0 || s <= 0 || out_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (s + kThreads - 1) / kThreads;
  expand_prefix_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const word*>(attrs), static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<word*>(out),
      static_cast<int*>(rank), a_rows, s, out_len);
  return static_cast<int>(cudaGetLastError());
}

// Both window launchers take the int64 inclusive prefix sum of the counts
// and a one-byte ok flag that the caller has set to 1.
extern "C" int litegs_expand_window(
    const void* attrs, const void* cum, void* out, void* rank, void* ok,
    int a_rows, int s, int out_len, int window_items, int slots_per_step,
    void* stream) {
  if (!window_args_ok(a_rows, s, out_len, window_items, slots_per_step))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = window_smem(window_items);
  const cudaError_t err = allow_smem(expand_window_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_window_kernel<<<steps_of(out_len, slots_per_step), kThreads,
                         smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const word*>(attrs), static_cast<const long long*>(cum),
      static_cast<word*>(out), static_cast<int*>(rank),
      static_cast<unsigned char*>(ok), a_rows, s, out_len, window_items,
      slots_per_step);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int litegs_expand_window_async(
    const void* attrs, const void* cum, void* out, void* rank, void* ok,
    int a_rows, int s, int out_len, int window_items, int slots_per_step,
    void* stream) {
  if (!window_args_ok(a_rows, s, out_len, window_items, slots_per_step))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = async_smem(a_rows, window_items, slots_per_step);
  const bool vec4 =
      s % 4 == 0 && reinterpret_cast<uintptr_t>(attrs) % 16 == 0;
  int grid = 0;
  cudaError_t err = vec4 ? allow_smem(expand_window_async_kernel<4>, smem)
                         : allow_smem(expand_window_async_kernel<1>, smem);
  if (err == cudaSuccess)
    err = vec4 ? persistent_grid(expand_window_async_kernel<4>,
                                 kAsyncThreads, smem,
                                 steps_of(out_len, slots_per_step), &grid)
               : persistent_grid(expand_window_async_kernel<1>,
                                 kAsyncThreads, smem,
                                 steps_of(out_len, slots_per_step), &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LITEGS_LAUNCH(VEC)                                                   \
  expand_window_async_kernel<VEC><<<grid, kAsyncThreads, smem, st>>>(        \
      static_cast<const word*>(attrs), static_cast<const long long*>(cum),   \
      static_cast<word*>(out), static_cast<int*>(rank),                      \
      static_cast<unsigned char*>(ok), a_rows, s, out_len, window_items,     \
      slots_per_step)
  if (vec4) {
    LITEGS_LAUNCH(4);
  } else {
    LITEGS_LAUNCH(1);
  }
#undef LITEGS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// src_lo is int64 when idx64 is nonzero, else int32.
extern "C" int litegs_gather_blocks(
    const void* attrs, const void* src_lo, void* out, int a_rows, int s,
    int nb, int idx64, void* stream) {
  if (a_rows <= 0 || s <= 0 || nb <= 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = kGatherThreads / 32;
  const long long blocks =
      (static_cast<long long>(nb) + kRunsInFlight * warps - 1) /
      (kRunsInFlight * warps);
  int grid = 0;
  const cudaError_t err =
      idx64 ? persistent_grid(gather_blocks_kernel<long long>,
                              kGatherThreads, 0, blocks, &grid)
            : persistent_grid(gather_blocks_kernel<int>, kGatherThreads, 0,
                              blocks, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64)
    gather_blocks_kernel<long long><<<grid, kGatherThreads, 0, st>>>(
        static_cast<const word*>(attrs),
        static_cast<const long long*>(src_lo), static_cast<word*>(out),
        a_rows, s, nb);
  else
    gather_blocks_kernel<int><<<grid, kGatherThreads, 0, st>>>(
        static_cast<const word*>(attrs), static_cast<const int*>(src_lo),
        static_cast<word*>(out), a_rows, s, nb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* litegs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
