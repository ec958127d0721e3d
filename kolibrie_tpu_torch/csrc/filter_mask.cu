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
// reads, plus the 1-byte mask written, at 3.35 TB/s.  Design:
//   1. One kernel per pattern: the active clauses and the op are template
//      parameters (8 x 7 instantiations, picked by the entry), so a scan
//      reads only its columns and runs no branch on the pattern; the
//      predicate-only scan of every premise is one compare a row.  The
//      constants are kernel parameters (by value).
//   2. One thread takes four consecutive rows and runs no loop: two 16-byte
//      loads of each column it reads, then the compares, then one 4-byte
//      store of the four mask bytes; the last n % 4 rows take one thread
//      each.  As many 256-thread blocks as the rows need.
//   On the H100 this timed fastest of the layouts tried at 1M rows (the RSP
//   scan, whose columns stay in L2) and level with the rest at 33.5M (the
//   closure's, about 90% of the bound, where torch.eq lands too): 16 rows a
//   thread, 8 or 4 rows a lane with lane-interleaved 16-byte loads, grids
//   persistent or not, and a shared-memory ring of bulk copies filled under
//   mbarriers (PERF.md, PR 5).
// The columns must start on 16-byte boundaries and the mask on a 4-byte
// one (the wrapper copies a column view that does not; the mask is a fresh
// allocation).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Consts {
  int64_t sc, pc, oc, o_cmp;
};

template <int A, int OP>
struct Pattern {
  static constexpr bool s = (A & 1) != 0;
  static constexpr bool p = (A & 2) != 0;
  static constexpr bool o = (A & 4) != 0;
  static constexpr bool read_o = o || OP >= 0;
};

template <int A, int OP>
__device__ __forceinline__ bool o_ok(int64_t v, const Consts& c) {
  bool m = true;
  if constexpr (Pattern<A, OP>::o) m = v == c.oc;
  if constexpr (OP == 0) m = m && v == c.o_cmp;
  if constexpr (OP == 1) m = m && v != c.o_cmp;
  if constexpr (OP == 2) m = m && v < c.o_cmp;
  if constexpr (OP == 3) m = m && v <= c.o_cmp;
  if constexpr (OP == 4) m = m && v > c.o_cmp;
  if constexpr (OP == 5) m = m && v >= c.o_cmp;
  return m;
}

// one row; a column the pattern does not read is never touched
template <int A, int OP>
__device__ __forceinline__ bool row_ok(int64_t sv, int64_t pv, int64_t ov, const Consts& c) {
  using P = Pattern<A, OP>;
  bool m = true;
  if constexpr (P::s) m = m && sv == c.sc;
  if constexpr (P::p) m = m && pv == c.pc;
  if constexpr (P::read_o) m = m && o_ok<A, OP>(ov, c);
  return m;
}

template <int A, int OP>
__global__ void __launch_bounds__(kThreads)
    filter_mask_kernel(const int64_t* __restrict__ s, const int64_t* __restrict__ p,
                       const int64_t* __restrict__ o, int64_t n, Consts c,
                       bool* __restrict__ mask) {
  using P = Pattern<A, OP>;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t quads = n / 4;
  if (t < quads) {
    longlong2 vs[2] = {}, vp[2] = {}, vo[2] = {};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if constexpr (P::s) vs[j] = reinterpret_cast<const longlong2*>(s)[2 * t + j];
      if constexpr (P::p) vp[j] = reinterpret_cast<const longlong2*>(p)[2 * t + j];
      if constexpr (P::read_o) vo[j] = reinterpret_cast<const longlong2*>(o)[2 * t + j];
    }
    unsigned w = 0;  // byte r: row 4 t + r
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      w |= unsigned(row_ok<A, OP>(vs[j].x, vp[j].x, vo[j].x, c)) << (16 * j);
      w |= unsigned(row_ok<A, OP>(vs[j].y, vp[j].y, vo[j].y, c)) << (16 * j + 8);
    }
    reinterpret_cast<unsigned*>(mask)[t] = w;
  }
  const int64_t i = quads * 4 + t;  // the last n % 4 rows
  if (t < 4 && i < n) {
    mask[i] = row_ok<A, OP>(P::s ? s[i] : 0, P::p ? p[i] : 0, P::read_o ? o[i] : 0, c);
  }
}

template <int A, int OP>
int launch(const int64_t* s, const int64_t* p, const int64_t* o, int64_t n, const Consts& c,
           bool* mask, cudaStream_t stream) {
  const int64_t threads = n / 4 > 4 ? n / 4 : 4;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  filter_mask_kernel<A, OP><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      s, p, o, n, c, mask);
  return static_cast<int>(cudaGetLastError());
}

template <int A>
int launch_op(int o_op, const int64_t* s, const int64_t* p, const int64_t* o, int64_t n,
              const Consts& c, bool* mask, cudaStream_t stream) {
  switch (o_op) {
    case -1: return launch<A, -1>(s, p, o, n, c, mask, stream);
    case 0: return launch<A, 0>(s, p, o, n, c, mask, stream);
    case 1: return launch<A, 1>(s, p, o, n, c, mask, stream);
    case 2: return launch<A, 2>(s, p, o, n, c, mask, stream);
    case 3: return launch<A, 3>(s, p, o, n, c, mask, stream);
    case 4: return launch<A, 4>(s, p, o, n, c, mask, stream);
    case 5: return launch<A, 5>(s, p, o, n, c, mask, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const Consts c{sc, pc, oc, o_cmp};
  const auto* S = static_cast<const int64_t*>(s);
  const auto* P = static_cast<const int64_t*>(p);
  const auto* O = static_cast<const int64_t*>(o);
  auto* M = static_cast<bool*>(mask);
  auto st = static_cast<cudaStream_t>(stream);
  const int op = static_cast<int>(o_op);
  switch (active) {
    case 0: return launch_op<0>(op, S, P, O, n, c, M, st);
    case 1: return launch_op<1>(op, S, P, O, n, c, M, st);
    case 2: return launch_op<2>(op, S, P, O, n, c, M, st);
    case 3: return launch_op<3>(op, S, P, O, n, c, M, st);
    case 4: return launch_op<4>(op, S, P, O, n, c, M, st);
    case 5: return launch_op<5>(op, S, P, O, n, c, M, st);
    case 6: return launch_op<6>(op, S, P, O, n, c, M, st);
    case 7: return launch_op<7>(op, S, P, O, n, c, M, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
