// Elementwise semiring tag combine over f32 tag columns.
//
// Replaces kolibrie_tpu/ops/pallas_kernels.py:_tag_kernel_factory (the
// Pallas TPU kernels behind tag_combine): out[i] = a[i] (+) b[i] for
//   0 min, 1 max       (MinMaxProbability, ExpirationProvenance)
//   2 mul, 3 noisy_or  (AddMultProbability: 1 - (1 - a)(1 - b))
//
// Bit-exact with the plain PyTorch versions in ops/kernels.py, which give
// the reference's jnp.minimum / jnp.maximum / fused noisy-or:
// - min/max are NaN-propagating selects that order -0 below +0,
//   `(a < b || a != a || (a == b && signbit(a))) ? a : b`; fminf and fmaxf
//   would return the non-NaN operand;
// - mul rounds once (__fmul_rn); noisy-or rounds 1 - a and 1 - b on their
//   own (__fsub_rn) and then 1 - (1 - a)(1 - b) once, as one fused
//   multiply-add (__fmaf_rn): XLA contracts the reference's expression so.
//   The intrinsics keep nvcc's -fmad from choosing otherwise.
//
// Bound on the H100: bytes, 12 a row (two f32 read, one written) at
// 3.35 TB/s.  Design: the op is a template parameter, so each launch runs
// one branch-free loop; each thread takes four elements (grid-stride) with
// 16-byte loads and stores, and the last n % 4 elements take one thread
// each.  The three columns must start on 16-byte boundaries (the wrapper
// copies a view that does not).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

template <int Op>
__device__ __forceinline__ float combine(float a, float b) {
  if (Op == 0) return (a < b || a != a || (a == b && signbit(a))) ? a : b;
  if (Op == 1) return (a > b || a != a || (a == b && !signbit(a))) ? a : b;
  if (Op == 2) return __fmul_rn(a, b);
  return __fmaf_rn(-__fsub_rn(1.0f, a), __fsub_rn(1.0f, b), 1.0f);
}

template <int Op>
__global__ void tag_combine_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b, int64_t n,
                                   float* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t quads = n >> 2;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int64_t k = t0; k < quads; k += stride) {
    const float4 x = a4[k], y = b4[k];
    o4[k] = make_float4(combine<Op>(x.x, y.x), combine<Op>(x.y, y.y),
                        combine<Op>(x.z, y.z), combine<Op>(x.w, y.w));
  }
  const int64_t i = (quads << 2) + t0;  // the last n % 4 elements
  if (i < n) out[i] = combine<Op>(a[i], b[i]);
}

}  // namespace

extern "C" int kolibrie_tag_combine(const void* a, const void* b, int64_t n,
                                    int64_t op, void* out, void* stream) {
  if (n <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fo = static_cast<float*>(out);
  int64_t blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (op) {
    case 0: tag_combine_kernel<0><<<grid, kThreads, 0, st>>>(fa, fb, n, fo); break;
    case 1: tag_combine_kernel<1><<<grid, kThreads, 0, st>>>(fa, fb, n, fo); break;
    case 2: tag_combine_kernel<2><<<grid, kThreads, 0, st>>>(fa, fb, n, fo); break;
    case 3: tag_combine_kernel<3><<<grid, kThreads, 0, st>>>(fa, fb, n, fo); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
