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
// Bound on the H100: bytes moved (17 bytes written per slot plus the
// compacted rows read once), at 3.35 TB/s.  Design: one launch for any
// size.  A block owns kTile consecutive slots; one binary search over cum
// finds its first row (the merge-path partition), the block stages that
// row's window in shared memory — at most kTile + 1 rows, because every
// compacted row emits at least one output — and each thread
// binary-searches the window for its slot's row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // output slots per block == threads per block

__global__ void merge_path_join_kernel(const int64_t* __restrict__ cum,
                                       const int64_t* __restrict__ low_c,
                                       const int64_t* __restrict__ lidx_c,
                                       const int64_t* __restrict__ total_ptr,
                                       int64_t n_rows, int64_t ln, int64_t rn,
                                       int64_t cap, int64_t* __restrict__ li,
                                       int64_t* __restrict__ ri,
                                       bool* __restrict__ valid) {
  // s_cum[0] = cum of the row before the window (0 at the start),
  // s_cum[1 + j] = cum[row0 + j] for the window's rows
  __shared__ int64_t s_cum[kTile + 2];
  __shared__ int64_t s_row0;
  __shared__ int s_w;

  const int64_t total = *total_ptr;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t k = t0 + threadIdx.x;

  if (t0 >= total) {  // the whole tile lies past the last match
    if (k < cap) {
      li[k] = 0;
      ri[k] = 0;
      valid[k] = false;
    }
    return;
  }
  if (threadIdx.x == 0) {
    // merge-path partition: first compacted row whose cum exceeds t0
    int64_t lo = 0, hi = n_rows;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (cum[mid] <= t0) lo = mid + 1; else hi = mid;
    }
    s_row0 = lo;
    const int64_t rest = n_rows - lo;
    s_w = static_cast<int>(rest < kTile + 1 ? rest : kTile + 1);
    s_cum[0] = lo > 0 ? cum[lo - 1] : 0;
  }
  __syncthreads();
  const int64_t row0 = s_row0;
  const int w = s_w;
  for (int j = threadIdx.x; j < w; j += blockDim.x) s_cum[1 + j] = cum[row0 + j];
  __syncthreads();

  if (k >= cap) return;
  if (k >= total) {
    li[k] = 0;
    ri[k] = 0;
    valid[k] = false;
    return;
  }
  // first window row whose cum exceeds k
  int lo = 0, hi = w;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_cum[1 + mid] <= k) lo = mid + 1; else hi = mid;
  }
  const int64_t row = row0 + lo;
  int64_t l = lidx_c[row];
  l = l < 0 ? 0 : (l > ln - 1 ? ln - 1 : l);
  int64_t r = low_c[row] + (k - s_cum[lo]);
  r = r < 0 ? 0 : (r > rn - 1 ? rn - 1 : r);
  li[k] = l;
  ri[k] = r;
  valid[k] = true;
}

}  // namespace

extern "C" int kolibrie_merge_path_join(const void* cum, const void* low_c,
                                        const void* lidx_c,
                                        const void* total, int64_t n_rows,
                                        int64_t ln, int64_t rn, int64_t cap,
                                        void* li, void* ri, void* valid,
                                        void* stream) {
  if (cap <= 0) return 0;
  const int64_t blocks = (cap + kTile - 1) / kTile;
  merge_path_join_kernel<<<static_cast<unsigned>(blocks), kTile, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(cum), static_cast<const int64_t*>(low_c),
      static_cast<const int64_t*>(lidx_c),
      static_cast<const int64_t*>(total), n_rows, ln, rn, cap,
      static_cast<int64_t*>(li), static_cast<int64_t*>(ri),
      static_cast<bool*>(valid));
  return static_cast<int>(cudaGetLastError());
}
