// Fused triple-pattern filter mask for the device fixpoint's premise scans.
//
// Replaces kolibrie_tpu/ops/pallas_kernels.py:_filter_kernel (the Pallas
// TPU kernel behind filter_mask).  For every row i:
//   mask[i] = (s[i] == sc or s wild) & (p[i] == pc or p wild)
//           & (o[i] == oc or o wild) & (o[i] <op> o_cmp, or no op)
// with op one of eq, ne, lt, le, gt, ge.  The columns are the port's int64
// carriers of u32 IDs (0 .. 2^32-1), so the signed compares below give the
// unsigned order the TPU kernel gets from its sign-bit flip, IDs with bit 31
// set (quoted triples) included.
//
// Bound on the H100: bytes.  8 bytes a row of every column an active clause
// reads, plus the 1-byte mask written, at 3.35 TB/s.  Design: the constants
// are kernel parameters (by value), and the kernel reads only the columns
// whose clause is active, so a predicate-only scan (every premise of the
// LUBM closure) moves 9 bytes a row, not 25.  Each thread takes four rows
// (grid-stride): two 16-byte loads per active column and one 4-byte store
// of the four mask bytes, so a warp keeps 1 KB of loads in flight per
// column; the last n % 4 rows take one thread each.  The columns must start
// on 16-byte boundaries and the mask on a 4-byte one (the wrapper copies a
// view that does not).  The branches on the active clauses and the op are
// uniform across the grid.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr int kS = 1, kP = 2, kO = 4;

struct Clauses {
  int64_t sc, pc, oc, o_cmp;
  int active, o_op;
};

__device__ __forceinline__ bool o_ok(int64_t ov, const Clauses& q) {
  bool m = !(q.active & kO) || ov == q.oc;
  switch (q.o_op) {
    case 0: return m && ov == q.o_cmp;
    case 1: return m && ov != q.o_cmp;
    case 2: return m && ov < q.o_cmp;
    case 3: return m && ov <= q.o_cmp;
    case 4: return m && ov > q.o_cmp;
    case 5: return m && ov >= q.o_cmp;
    default: return m;
  }
}

__device__ __forceinline__ bool row_ok(const int64_t* __restrict__ s,
                                       const int64_t* __restrict__ p,
                                       const int64_t* __restrict__ o, int64_t i,
                                       bool read_o, const Clauses& q) {
  bool m = true;
  if (q.active & kS) m = m && s[i] == q.sc;
  if (q.active & kP) m = m && p[i] == q.pc;
  if (read_o) m = m && o_ok(o[i], q);
  return m;
}

// Four rows of one column compared with c: bit j set when row 4k+j matches.
__device__ __forceinline__ unsigned eq4(const int64_t* __restrict__ col,
                                        int64_t k, int64_t c) {
  const longlong2* v = reinterpret_cast<const longlong2*>(col) + 2 * k;
  const longlong2 a = v[0], b = v[1];
  return (a.x == c) | (a.y == c) << 1 | (b.x == c) << 2 | (b.y == c) << 3;
}

__global__ void filter_mask_kernel(const int64_t* __restrict__ s,
                                   const int64_t* __restrict__ p,
                                   const int64_t* __restrict__ o, int64_t n,
                                   Clauses q, bool* __restrict__ mask) {
  const bool read_o = (q.active & kO) || q.o_op >= 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t quads = n >> 2;
  for (int64_t k = t0; k < quads; k += stride) {
    unsigned m = 0xF;
    if (q.active & kS) m &= eq4(s, k, q.sc);
    if (q.active & kP) m &= eq4(p, k, q.pc);
    if (read_o) {
      const longlong2* v = reinterpret_cast<const longlong2*>(o) + 2 * k;
      const longlong2 a = v[0], b = v[1];
      m &= o_ok(a.x, q) | o_ok(a.y, q) << 1 | o_ok(b.x, q) << 2 | o_ok(b.y, q) << 3;
    }
    // one byte per row, 0 or 1: the four bools of rows 4k .. 4k+3
    reinterpret_cast<uint32_t*>(mask)[k] =
        (m & 1) | (m >> 1 & 1) << 8 | (m >> 2 & 1) << 16 | (m >> 3 & 1) << 24;
  }
  const int64_t i = (quads << 2) + t0;  // the last n % 4 rows
  if (i < n) mask[i] = row_ok(s, p, o, i, read_o, q);
}

}  // namespace

extern "C" int kolibrie_filter_mask(const void* s, const void* p, const void* o,
                                    int64_t n, int64_t sc, int64_t pc,
                                    int64_t oc, int64_t active, int64_t o_op,
                                    int64_t o_cmp, void* mask, void* stream) {
  if (n <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(p) |
       reinterpret_cast<uintptr_t>(o)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(mask) % 4 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const Clauses q{sc, pc, oc, o_cmp, static_cast<int>(active), static_cast<int>(o_op)};
  int64_t blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  filter_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(s), static_cast<const int64_t*>(p),
      static_cast<const int64_t*>(o), n, q, static_cast<bool*>(mask));
  return static_cast<int>(cudaGetLastError());
}
