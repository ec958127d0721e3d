// Merge-path equi-join expansion for the device query engine.
//
// Replaces kolibrie_tpu/ops/pallas_kernels.py:_merge_join_kernel (the
// Pallas TPU tile kernel behind merge_join_indices and
// ranked_merge_join_indices).  Input is the prepass of
// kolibrie_tpu_torch/ops/kernels.py:_join_prepass: left rows compacted so
// that every row with >= 1 match comes first, with
//   cum[r]    inclusive prefix of the per-row match counts,
//   low_c[r]  first matching position in the sorted right keys,
//   lidx_c[r] the row's index in the original left input.
// For each output slot k < cap the kernel finds the row r whose match
// range [cum[r-1], cum[r]) holds k and writes
//   li = lidx_c[r], ri = low_c[r] + (k - cum[r-1]), valid = k < total
// (indices clamped into the inputs; invalid slots are 0).
//
// Bound on the H100: bytes.  17 bytes written per slot (li, ri, valid) and
// the compacted rows that feed the slots read once (24 bytes each), at
// 3.35 TB/s.  Design: one launch for any size, kTile = 1024 slots per
// 256-thread block, 4 consecutive slots a thread.
//   1. total is read on the device, beside the first partition step's
//      splitters (the same for every block); a tile wholly past total
//      writes zeros and searches nothing.
//   2. Partition: the block's two halves search cum at once, one for the
//      tile's first row and one for its last (first row with cum > slot),
//      each 128-ary — every step 128 threads load 128 evenly spaced
//      splitters and ballots narrow the range 128-fold — until at most
//      kSlack rows remain: one dependent load after total at a million
//      rows, two at 16M, where thread 0's binary search took 20-24.
//   3. The window (the tile's rows, at most kTile since every compacted
//      row emits at least one slot, plus up to kSlack on each side; a row
//      whose fan-out spans tiles is a window of one) is copied into shared
//      memory with 8-byte cp.async: cum, low and lidx and the cum before.
//   4. Each thread binary-searches the window once for its first slot and
//      walks forward, advancing the row when k reaches the next cum; no
//      global gather per slot.
//   5. li and ri go back through shared memory so that consecutive threads
//      store consecutive 16-byte chunks (a thread's own slots stored as
//      16-byte words left half of every 32-byte sector to another store
//      and halved the write rate); valid is 4 bytes a thread, consecutive
//      already.
// The tile size and slots a thread timed fastest on the H100 of 2048 x 8,
// 1024 x 4, 512 x 2, 512 x 4 (128 threads) and 1024 x 8 (128 threads).  The
// outputs must start on 16-byte boundaries (the wrapper's fresh
// allocations do).  Rows with no match may follow the matched rows only
// (the prepass's order); other inputs can give windows wider than
// kTile + 2 kSlack rows, which are cut to that.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 4;                      // consecutive slots a thread
constexpr int kTile = kThreads * kSlots;       // output slots a block
constexpr int kHalf = kThreads / 2;            // threads of one partition search
constexpr int kWarpsPerHalf = kHalf / 32;
constexpr int kSlack = 63;                     // rows a finished search may leave open
constexpr int kWin = kTile + 2 * kSlack;       // most rows a window holds

__device__ __forceinline__ void cp_async8(int64_t* dst, const int64_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a load the compiler keeps where it is written (not sunk into a branch)
__device__ __forceinline__ int64_t load_now(const int64_t* p) {
  int64_t v;
  asm volatile("ld.global.nc.b64 %0, [%1];\n" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ int64_t clamp(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// slots k, k + 1 of an output: one 16-byte store, or what lies below cap
__device__ __forceinline__ void store_pair(int64_t* __restrict__ out, int64_t k, longlong2 v,
                                           int64_t cap) {
  if (k + 1 < cap) {
    *reinterpret_cast<longlong2*>(out + k) = v;
  } else if (k < cap) {
    out[k] = v.x;
  }
}

__global__ void __launch_bounds__(kThreads)
    merge_path_join_kernel(const int64_t* __restrict__ cum,
                           const int64_t* __restrict__ low_c,
                           const int64_t* __restrict__ lidx_c,
                           const int64_t* __restrict__ total_ptr, int64_t n_rows,
                           int64_t ln, int64_t rn, int64_t cap,
                           int64_t* __restrict__ li, int64_t* __restrict__ ri,
                           bool* __restrict__ valid) {
  // the window: s_cum[0] = cum of the row before it (0 at the start),
  // s_cum[1 + i] = cum[ws + i], s_low[i], s_lidx[i] likewise; later the
  // staging of li and ri
  __shared__ __align__(16) int64_t smem[3 * kWin + 1];
  int64_t* s_cum = smem;
  int64_t* s_low = smem + kWin + 1;
  int64_t* s_lidx = s_low + kWin;
  __shared__ unsigned s_ballot[kThreads / 32];
  __shared__ int64_t s_edge[2];

  const int tid = threadIdx.x;
  const int half = tid / kHalf, j = tid % kHalf;
  // the first search step's splitter, issued beside the load of total
  const int64_t step1 = (n_rows + kHalf - 1) / kHalf;
  const int64_t first = load_now(cum + lmin((j + 1) * step1 - 1, n_rows - 1));
  const int64_t total = *total_ptr;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t k0 = t0 + static_cast<int64_t>(tid) * kSlots;
  unsigned vbits = 0;

  if (t0 < total) {
    // ---- partition: half 0 narrows [lo, hi] around r0 (first row with
    // cum > t0), half 1 around r1 (first row with cum > the tile's last
    // live slot); hi == n_rows or cum[hi] > x throughout
    const int64_t last = lmin(lmin(t0 + kTile, total), cap) - 1;
    const int64_t x = half ? last : t0;
    int64_t lo = 0, hi = n_rows;
    bool round1 = true;
    while (__syncthreads_or(hi - lo > kSlack)) {
      const bool open = hi - lo > kSlack;
      const int64_t step = (hi - lo + kHalf - 1) / kHalf;
      const int64_t idx = lo + (j + 1) * step - 1;
      const bool pred = !open || idx >= hi || (round1 ? first : cum[idx]) > x;
      round1 = false;
      const unsigned b = __ballot_sync(0xFFFFFFFFu, pred);
      if ((tid & 31) == 0) s_ballot[tid >> 5] = b;
      __syncthreads();
      if (open) {
        int f = -1;  // first splitter of this half past x
#pragma unroll
        for (int w = 0; w < kWarpsPerHalf; ++w) {
          const unsigned bw = s_ballot[half * kWarpsPerHalf + w];
          if (f < 0 && bw) f = w * 32 + __ffs(bw) - 1;
        }
        if (f < 0) {
          lo = hi;
        } else {
          const int64_t nhi = lo + (f + 1) * step - 1;
          lo += f * step;
          hi = lmin(nhi, hi);
        }
      }
    }
    if (j == 0) s_edge[half] = half ? hi : lo;
    __syncthreads();
    const int64_t ws = lmin(s_edge[0], n_rows - 1);  // <= r0
    const int64_t rows = lmin(s_edge[1], n_rows - 1) - ws + 1;  // through >= r1
    const int w = rows < 1 ? 1 : static_cast<int>(lmin(rows, kWin));

    // ---- the window into shared memory
    if (tid == 0 && ws == 0) s_cum[0] = 0;
    for (int i = tid; i <= w; i += kThreads) {
      if (ws - 1 + i >= 0) cp_async8(&s_cum[i], cum + ws - 1 + i);
      if (i < w) {
        cp_async8(&s_low[i], low_c + ws + i);
        cp_async8(&s_lidx[i], lidx_c + ws + i);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- one search for the first slot, then walk
    int64_t l[kSlots] = {}, r[kSlots] = {};
    if (k0 < total && k0 < cap) {
      int a = 0, z = w - 1;  // first window row whose cum exceeds k0
      while (a < z) {
        const int mid = (a + z) >> 1;
        if (s_cum[1 + mid] <= k0) a = mid + 1; else z = mid;
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int64_t k = k0 + s;
        if (k < total) {
          while (a < w - 1 && s_cum[1 + a] <= k) ++a;
          l[s] = clamp(s_lidx[a], ln - 1);
          r[s] = clamp(s_low[a] + (k - s_cum[a]), rn - 1);
          vbits |= 1u << (8 * s);
        }
      }
    }

    // ---- li and ri through shared memory (over the window, which every
    // thread is done with): consecutive threads store consecutive 16-byte
    // chunks
    __syncthreads();
    longlong2* s_l = reinterpret_cast<longlong2*>(smem);
    longlong2* s_r = s_l + kTile / 2;
#pragma unroll
    for (int q = 0; q < kSlots / 2; ++q) {
      s_l[tid * (kSlots / 2) + q] = make_longlong2(l[2 * q], l[2 * q + 1]);
      s_r[tid * (kSlots / 2) + q] = make_longlong2(r[2 * q], r[2 * q + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int c = tid; c < kTile / 2; c += kThreads) {
      store_pair(li, t0 + 2 * c, s_l[c], cap);
      store_pair(ri, t0 + 2 * c, s_r[c], cap);
    }
  } else {
    const longlong2 zero = make_longlong2(0, 0);
#pragma unroll
    for (int c = tid; c < kTile / 2; c += kThreads) {
      store_pair(li, t0 + 2 * c, zero, cap);
      store_pair(ri, t0 + 2 * c, zero, cap);
    }
  }

  // ---- valid: kSlots bytes a thread, consecutive threads on consecutive bytes
  static_assert(kSlots == 4, "valid is stored as one 4-byte word a thread");
  if (k0 + kSlots <= cap) {
    *reinterpret_cast<unsigned*>(valid + k0) = vbits;
  } else {
    for (int s = 0; s < kSlots && k0 + s < cap; ++s) valid[k0 + s] = (vbits >> (8 * s)) & 1;
  }
}

}  // namespace

extern "C" int kolibrie_merge_path_join(const void* cum, const void* low_c,
                                        const void* lidx_c,
                                        const void* total, int64_t n_rows,
                                        int64_t ln, int64_t rn, int64_t cap,
                                        void* li, void* ri, void* valid,
                                        void* stream) {
  if (cap <= 0) return 0;
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(li) | reinterpret_cast<uintptr_t>(ri) |
       reinterpret_cast<uintptr_t>(valid)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int64_t blocks = (cap + kTile - 1) / kTile;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  merge_path_join_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(cum), static_cast<const int64_t*>(low_c),
      static_cast<const int64_t*>(lidx_c),
      static_cast<const int64_t*>(total), n_rows, ln, rn, cap,
      static_cast<int64_t*>(li), static_cast<int64_t*>(ri),
      static_cast<bool*>(valid));
  return static_cast<int>(cudaGetLastError());
}
