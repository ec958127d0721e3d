// WCOJ lex-probe kernels: one worst-case-optimal join level's per-slot
// candidate selection and validation.
//
// Replace kolibrie_tpu/ops/pallas_kernels.py:_lex_probe_select_kernel and
// _lex_probe_validate_kernel.  Both are elementwise, one thread per slot.
// The accessor count is a runtime argument: each accessor's column
// addresses (5 per accessor for select, 7 for validate) arrive by value in
// a kernel-parameter table of up to kMaxAccessors accessors, so a launch
// needs no host-to-device copy and no stream synchronisation.
//
// Bound on the H100: bytes moved, at 3.35 TB/s.  select reads the slot's
// chosen accessor only, and of it only the base or the delta side (the
// reference computes every accessor and then selects); validate skips every
// accessor read for a slot that is already invalid, since no probe can make
// it valid again.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAccessors = 16;
constexpr int64_t kSent = 0xFFFFFFFFLL;  // u32 never-an-ID sentinel

// col[5a + 0..4] = nb, bval, dval, bprev, dprev of accessor a
struct SelectTable {
  const int64_t* col[5 * kMaxAccessors];
};

// col[7a + 0..5] = fl, fh, tl, th, dl2, dh2 (int64), col[7a + 6] = sent (bool)
struct ValidateTable {
  const void* col[7 * kMaxAccessors];
};

__global__ void lex_probe_select_kernel(const int64_t* __restrict__ kk,
                                        const int64_t* __restrict__ ch,
                                        const bool* __restrict__ in_range,
                                        const SelectTable acc, int64_t p,
                                        int64_t* __restrict__ val,
                                        bool* __restrict__ ok,
                                        bool* __restrict__ is_base) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const int64_t k = kk[i];
  const int64_t c = ch[i];
  // pick the chosen accessor's columns with constant table offsets (a
  // runtime index into the parameter table would copy it to local memory)
  const int64_t* const* a = acc.col;
#pragma unroll
  for (int j = 1; j < kMaxAccessors; ++j) {
    if (j == c) a = acc.col + 5 * j;
  }
  const int64_t nb = a[0][i];
  const bool base = k < nb;
  int64_t v;
  bool first;
  if (base) {
    v = a[1][i];
    first = (k == 0) || (a[3][i] != v);
  } else {
    v = a[2][i];
    first = (k == nb) || (a[4][i] != v);
  }
  val[i] = v;
  is_base[i] = base;
  ok[i] = in_range[i] && v != kSent && first;
}

__global__ void lex_probe_validate_kernel(const bool* __restrict__ ok,
                                          const bool* __restrict__ is_base,
                                          const int64_t* __restrict__ ch,
                                          const ValidateTable acc,
                                          int a_count, int64_t p,
                                          bool* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p) return;
  if (!ok[i]) {
    out[i] = false;
    return;
  }
  const int64_t c = ch[i];
  bool v = true;
  bool braw = false;
#pragma unroll
  for (int a = 0; a < kMaxAccessors; ++a) {
    if (a >= a_count) break;
    const void* const* t = acc.col + 7 * a;
    const int64_t fl = static_cast<const int64_t*>(t[0])[i];
    const int64_t fh = static_cast<const int64_t*>(t[1])[i];
    const int64_t tl = static_cast<const int64_t*>(t[2])[i];
    const int64_t th = static_cast<const int64_t*>(t[3])[i];
    const int64_t dl2 = static_cast<const int64_t*>(t[4])[i];
    const int64_t dh2 = static_cast<const int64_t*>(t[5])[i];
    const bool sent = static_cast<const bool*>(t[6])[i];
    // live copies = raw base range - tombstoned + delta range
    v = v && ((fh - fl) - (th - tl) + (dh2 - dl2)) > 0 && !sent;
    if (a == c) braw = (fh - fl) > 0;
  }
  // a delta-enumerated value whose base also has raw copies defers to the
  // base slot as the unique representative
  out[i] = v && (is_base[i] || !braw);
}

unsigned blocks_for(int64_t p) {
  return static_cast<unsigned>((p + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int kolibrie_lex_probe_max_accessors() { return kMaxAccessors; }

// `acc` is a host array of 5 * a_count column addresses.
extern "C" int kolibrie_lex_probe_select(const void* kk, const void* ch,
                                         const void* in_range, const void* acc,
                                         int64_t a_count, int64_t p, void* val,
                                         void* ok, void* is_base,
                                         void* stream) {
  if (a_count < 1 || a_count > kMaxAccessors) return cudaErrorInvalidValue;
  if (p <= 0) return 0;
  SelectTable table{};
  const int64_t* const* cols = static_cast<const int64_t* const*>(acc);
  for (int64_t j = 0; j < 5 * a_count; ++j) table.col[j] = cols[j];
  lex_probe_select_kernel<<<blocks_for(p), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(kk), static_cast<const int64_t*>(ch),
      static_cast<const bool*>(in_range), table, p, static_cast<int64_t*>(val),
      static_cast<bool*>(ok), static_cast<bool*>(is_base));
  return static_cast<int>(cudaGetLastError());
}

// `acc` is a host array of 7 * a_count column addresses.
extern "C" int kolibrie_lex_probe_validate(const void* ok, const void* is_base,
                                           const void* ch, const void* acc,
                                           int64_t a_count, int64_t p,
                                           void* out, void* stream) {
  if (a_count < 1 || a_count > kMaxAccessors) return cudaErrorInvalidValue;
  if (p <= 0) return 0;
  ValidateTable table{};
  const void* const* cols = static_cast<const void* const*>(acc);
  for (int64_t j = 0; j < 7 * a_count; ++j) table.col[j] = cols[j];
  lex_probe_validate_kernel<<<blocks_for(p), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(ok), static_cast<const bool*>(is_base),
      static_cast<const int64_t*>(ch), table, static_cast<int>(a_count), p,
      static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}
