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
// operations per slot.  The designs keep writes coalesced along slots and
// the re-reads of an item's attributes in cache or shared memory.
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
// expand_window_async_kernel: the plan and decode of expand_window_kernel,
// with the window's attribute rows staged in shared memory as well, by
// asynchronous copies (cp.async) started before its starts are loaded and
// waited on after, so every attribute word comes from shared memory.  VEC
// is the words per copy: 4 (16 bytes) when S is a multiple of 4 and attrs
// is 16-byte aligned (the window's base is a multiple of 128 items, so
// every copy is then aligned), else 1.
// ---------------------------------------------------------------------------
template <int VEC>
__global__ void __launch_bounds__(kThreads) expand_window_async_kernel(
    const word* __restrict__ attrs,     // [A, S]
    const long long* __restrict__ cum,  // [S] inclusive prefix sum
    word* __restrict__ out,             // [A, L]
    int* __restrict__ rank,             // [L]
    unsigned char* __restrict__ ok,     // 1 from the wrapper, 0 on overrun
    int a_rows, int s, int out_len, int window_items, int slots_per_step) {
  extern __shared__ __align__(16) word s_tile[];  // [A + 1, window]
  __shared__ int s_ab[2];
  const int window = window_items + kBlk;
  const long long s0 = static_cast<long long>(blockIdx.x) * slots_per_step;
  const int lo = step_plan(cum, s, s0, window_items, slots_per_step, ok, s_ab);
  if (lo < 0) return;  // uniform
  const int w0 = (lo / kBlk) * kBlk;
  const int chunks = window / VEC;
  const int n_copies = a_rows * chunks;
  for (int c = threadIdx.x; c < n_copies; c += blockDim.x) {
    const int row = c / chunks;
    const int j = (c - row * chunks) * VEC;
    const long long i = static_cast<long long>(w0) + j;
    word* dst = s_tile + static_cast<size_t>(row) * window + j;
    const word* src = attrs + static_cast<size_t>(row) * s + i;
    if (i + VEC <= s) {
      __pipeline_memcpy_async(dst, src, VEC * sizeof(word));
    } else {
      // past the last item the attributes read as zero
      for (int v = 0; v < VEC; ++v) dst[v] = i + v < s ? src[v] : 0u;
    }
  }
  __pipeline_commit();
  int* s_starts =
      reinterpret_cast<int*>(s_tile + static_cast<size_t>(a_rows) * window);
  stage_starts(cum, s, w0, window, s_starts);
  __pipeline_wait_prior(0);
  __syncthreads();
  const int n = static_cast<int>(
      min(static_cast<long long>(slots_per_step), out_len - s0));
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int slot = static_cast<int>(s0) + k;
    const int cnt = count_leq(s_starts, window, slot);
    const int local = max(cnt - 1, 0);
    const int start_at = cnt > 0 ? s_starts[local] : -1;
    rank[slot] = slot - start_at;
    for (int a = 0; a < a_rows; ++a)
      out[static_cast<size_t>(a) * out_len + slot] =
          s_tile[static_cast<size_t>(a) * window + local];
  }
}

// ---------------------------------------------------------------------------
// gather_blocks_kernel: one block per 128-slot run, one thread per slot:
// out[:, 128 b + j] = attrs[:, clip(src_lo[b], 0, S - 1) + j], zero past S.
// Both sides of the copy are coalesced.
// ---------------------------------------------------------------------------
__global__ void gather_blocks_kernel(
    const word* __restrict__ attrs,   // [A, S]
    const int* __restrict__ src_lo,   // [nb]
    word* __restrict__ out,           // [A, nb * 128]
    int a_rows, int s, int nb) {
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lo = min(max(src_lo[b], 0), s - 1);
  const long long i = static_cast<long long>(lo) + j;
  const size_t out_len = static_cast<size_t>(nb) * kBlk;
  const size_t dst = static_cast<size_t>(b) * kBlk + j;
  for (int a = 0; a < a_rows; ++a)
    out[static_cast<size_t>(a) * out_len + dst] =
        i < s ? attrs[static_cast<size_t>(a) * s + i] : 0u;
}

inline int steps_of(int out_len, int slots_per_step) {
  return (out_len + slots_per_step - 1) / slots_per_step;
}

inline bool window_args_ok(int a_rows, int s, int out_len, int window_items,
                           int slots_per_step) {
  return a_rows >= 0 && s > 0 && out_len > 0 && window_items > 0 &&
         window_items % kBlk == 0 && slots_per_step > 0;
}

// Dynamic shared memory of a window kernel's block: the window's starts,
// and its attribute rows for the async kernel.
inline size_t window_smem(int a_rows, int window_items, bool async) {
  return static_cast<size_t>(async ? a_rows + 1 : 1) *
         (window_items + kBlk) * sizeof(word);
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
  const size_t smem = window_smem(a_rows, window_items, false);
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
  const size_t smem = window_smem(a_rows, window_items, true);
  const bool vec4 =
      s % 4 == 0 && reinterpret_cast<uintptr_t>(attrs) % 16 == 0;
  const cudaError_t err = vec4 ? allow_smem(expand_window_async_kernel<4>, smem)
                               : allow_smem(expand_window_async_kernel<1>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int steps = steps_of(out_len, slots_per_step);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LITEGS_LAUNCH(VEC)                                                   \
  expand_window_async_kernel<VEC><<<steps, kThreads, smem, st>>>(            \
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

extern "C" int litegs_gather_blocks(
    const void* attrs, const void* src_lo, void* out, int a_rows, int s,
    int nb, void* stream) {
  if (a_rows <= 0 || s <= 0 || nb <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  gather_blocks_kernel<<<nb, kBlk, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const word*>(attrs), static_cast<const int*>(src_lo),
      static_cast<word*>(out), a_rows, s, nb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* litegs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
