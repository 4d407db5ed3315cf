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
// exclusive prefix sum of counts, formed by the wrapper), and slot e of its
// owner is at rank e - starts[owner].  This is the emit half of the
// reference's prefix-sum + emit (duplicate_with_keys, binning.cu:33-110).
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
// expand_window_kernel: slot-driven.  One block per slots_per_step output
// slots.  blk_lo[b] is the owner of the block's first slot (the wrapper's
// searchsorted); the window of `window` items anchored at
// floor(blk_lo[b] / 128) * 128 holds every owner of the block when the
// wrapper's `ok` is true.  The block loads the window's starts into shared
// memory, each thread binary-searches its slot's owner there and copies the
// owner's attribute words from device memory (neighbouring slots read the
// same or neighbouring items, so the reads hit in L1) into the slot,
// coalesced along slots.
// ---------------------------------------------------------------------------
__global__ void expand_window_kernel(
    const word* __restrict__ attrs,   // [A, S]
    const int* __restrict__ starts,   // [S]
    const int* __restrict__ blk_lo,   // [steps]
    word* __restrict__ out,           // [A, L]
    int* __restrict__ rank,           // [L]
    int a_rows, int s, int out_len, int window, int slots_per_step) {
  extern __shared__ int s_starts[];   // [window]
  const int b = blockIdx.x;
  const int w0 = (blk_lo[b] / kBlk) * kBlk;
  for (int j = threadIdx.x; j < window; j += blockDim.x) {
    const long long i = static_cast<long long>(w0) + j;
    s_starts[j] = i < s ? starts[i] : INT_MAX;
  }
  __syncthreads();
  const long long slot0 = static_cast<long long>(b) * slots_per_step;
  for (int k = threadIdx.x; k < slots_per_step; k += blockDim.x) {
    const long long slot_ll = slot0 + k;
    if (slot_ll >= out_len) break;
    const int slot = static_cast<int>(slot_ll);
    const int cnt = count_leq(s_starts, window, slot);
    const int local = max(cnt - 1, 0);
    const int start_at = cnt > 0 ? s_starts[local] : -1;
    rank[slot] = slot - start_at;
    const size_t src = static_cast<size_t>(w0) + local;
    for (int a = 0; a < a_rows; ++a)
      out[static_cast<size_t>(a) * out_len + slot] =
          attrs[static_cast<size_t>(a) * s + src];
  }
}

// ---------------------------------------------------------------------------
// expand_window_async_kernel: the contract and decode of
// expand_window_kernel, with the whole [A + 1, window] tile -- the window's
// attribute rows and, as row A, its starts (int32) -- staged into shared
// memory by asynchronous copies (cp.async) that are started before the
// block's slot ids are formed and waited on after.  Every attribute word
// then comes from shared memory.  VEC is the words per copy: 4 (16 bytes)
// when S is a multiple of 4 and both arrays are 16-byte aligned (the
// window's base is a multiple of 128 items, so every copy is then aligned),
// else 1.
// ---------------------------------------------------------------------------
template <int VEC>
__global__ void expand_window_async_kernel(
    const word* __restrict__ attrs,   // [A, S]
    const int* __restrict__ starts,   // [S]
    const int* __restrict__ blk_lo,   // [steps]
    word* __restrict__ out,           // [A, L]
    int* __restrict__ rank,           // [L]
    int a_rows, int s, int out_len, int window, int slots_per_step) {
  extern __shared__ __align__(16) word s_tile[];  // [A + 1, window]
  const int b = blockIdx.x;
  const int w0 = (blk_lo[b] / kBlk) * kBlk;
  const int chunks = window / VEC;
  const int n_copies = (a_rows + 1) * chunks;
  for (int c = threadIdx.x; c < n_copies; c += blockDim.x) {
    const int row = c / chunks;
    const int j = (c - row * chunks) * VEC;
    const long long i = static_cast<long long>(w0) + j;
    word* dst = s_tile + static_cast<size_t>(row) * window + j;
    const bool is_start = row == a_rows;
    const word* src = is_start
        ? reinterpret_cast<const word*>(starts) + i
        : attrs + static_cast<size_t>(row) * s + i;
    if (i + VEC <= s) {
      __pipeline_memcpy_async(dst, src, VEC * sizeof(word));
    } else {
      // past the last item: attributes read as zero, starts as INT_MAX
      for (int v = 0; v < VEC; ++v)
        dst[v] = i + v < s ? src[v]
                           : (is_start ? static_cast<word>(INT_MAX) : 0u);
    }
  }
  __pipeline_commit();
  const long long slot0 = static_cast<long long>(b) * slots_per_step;
  const int* s_starts =
      reinterpret_cast<const int*>(s_tile + static_cast<size_t>(a_rows) * window);
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int k = threadIdx.x; k < slots_per_step; k += blockDim.x) {
    const long long slot_ll = slot0 + k;
    if (slot_ll >= out_len) break;
    const int slot = static_cast<int>(slot_ll);
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

inline bool window_args_ok(int a_rows, int s, int out_len, int window,
                           int slots_per_step) {
  return a_rows > 0 && s > 0 && out_len > 0 && window > 0 &&
         window % kBlk == 0 && slots_per_step > 0;
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

extern "C" int litegs_expand_window(
    const void* attrs, const void* starts, const void* blk_lo, void* out,
    void* rank, int a_rows, int s, int out_len, int window,
    int slots_per_step, void* stream) {
  if (!window_args_ok(a_rows, s, out_len, window, slots_per_step))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(window) * sizeof(int);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        expand_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  expand_window_kernel<<<steps_of(out_len, slots_per_step), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const word*>(attrs), static_cast<const int*>(starts),
      static_cast<const int*>(blk_lo), static_cast<word*>(out),
      static_cast<int*>(rank), a_rows, s, out_len, window, slots_per_step);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int litegs_expand_window_async(
    const void* attrs, const void* starts, const void* blk_lo, void* out,
    void* rank, int a_rows, int s, int out_len, int window,
    int slots_per_step, void* stream) {
  if (!window_args_ok(a_rows, s, out_len, window, slots_per_step))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(a_rows + 1) * window * sizeof(word);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 =
      s % 4 == 0 && reinterpret_cast<uintptr_t>(attrs) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(starts) % 16 == 0;
  if (smem > kSmemDefault) {
    const cudaError_t err = vec4
        ? cudaFuncSetAttribute(expand_window_async_kernel<4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem))
        : cudaFuncSetAttribute(expand_window_async_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int steps = steps_of(out_len, slots_per_step);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LITEGS_LAUNCH(VEC)                                                   \
  expand_window_async_kernel<VEC><<<steps, kThreads, smem, st>>>(            \
      static_cast<const word*>(attrs), static_cast<const int*>(starts),      \
      static_cast<const int*>(blk_lo), static_cast<word*>(out),              \
      static_cast<int*>(rank), a_rows, s, out_len, window, slots_per_step)
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
