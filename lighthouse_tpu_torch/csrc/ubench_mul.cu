// The fused Fp-product microbenchmark: `k_ubench_mul` (one product per
// launch) and `k_ubench_mul_chain` (R products chained in one launch, R a
// kernel argument), the device half of
// lighthouse_tpu_torch/tools/ubench_mul.py.
//
// Replace the reference's Pallas kernels `_kernel` and `_kernel_chain`
// (tools/ubench_pallas.py:85, :93, launched through its pl.pallas_call at
// :107): the round-2 product, with a 3-pass carry normalization at every
// site (both entries, the 73-limb product, and after each of the three
// folds 73 -> 37, 37 -> 36, 36 -> 36), not the lane core's trimmed
// schedule; `_kernel_chain` runs x = mul(x, b) R times on the entry-normed
// operands.
//
// The tables are this library's own constant bank: ubench_mul.py hands its
// FOLDS [36, 41] and TOPFM [3, 73] (the microbenchmark's, rebuilt from the
// round-2 constants) to lh_ubench_mul_init.
//
// Bound on the H100: integer operations (per product 1,296 conv
// multiply-adds, 1,476 fold multiply-adds and 3 x (73 + 37 + 36 + 36)
// limb carry steps, ~8,500 int32 operations, against 432 bytes in and
// out; the chain does R of them on the same bytes). Design: one thread per
// lane element, as the lane `mul` (fp_mul.cu): limbs and the 73-limb
// accumulator in registers, the tables in constant memory, coalesced loads.
#include "fp_lane.cuh"

namespace {

using lh::CONVW;
using lh::W;

constexpr int PASSES = 3;

// the microbenchmark's `_mul_body` on entry-normed operands; out may alias a
__device__ __forceinline__ void ub_mul(int* out, const int* a, const int* b) {
  int wide[CONVW];
  lh::conv(a, b, wide);
  lh::norm<CONVW, PASSES>(wide);
  int x37[37];
  lh::fold<CONVW, 0>(wide, x37);
  x37[36] = 0;
  lh::norm<37, PASSES>(x37);
  int x36[W];
  lh::fold<37, 38>(x37, x36);
  lh::norm<W, PASSES>(x36);
  lh::fold<W, 40>(x36, out);
  lh::norm<W, PASSES>(out);
}

// both operands loaded and normed, then R products x <- x b
__device__ __forceinline__ void chain_elem(const int* __restrict__ a,
                                           const int* __restrict__ b,
                                           int* __restrict__ out, int R, int K,
                                           int S) {
  long base;
  if (!lh::elem_index(K, S, &base)) return;
  int x[W], y[W];
  lh::load_elem(x, a, base, S);
  lh::load_elem(y, b, base, S);
  lh::norm<W, PASSES>(x);
  lh::norm<W, PASSES>(y);
#pragma unroll 1
  for (int r = 0; r < R; ++r) ub_mul(x, x, y);
  lh::store_elem(out, x, base, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_ubench_mul(const int* __restrict__ a, const int* __restrict__ b,
                 int* __restrict__ out, int K, int S) {
  chain_elem(a, b, out, 1, K, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_ubench_mul_chain(const int* __restrict__ a, const int* __restrict__ b,
                       int* __restrict__ out, int R, int K, int S) {
  chain_elem(a, b, out, R, K, S);
}

}  // namespace

LH_EXPORT int lh_ubench_mul_init(const void* folds, const void* topfm) {
  return lh::copy_consts(folds, topfm);
}

LH_EXPORT const char* lh_ubench_mul_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_ubench_mul(const void* a, const void* b, void* out, int K,
                            int S, void* stream) {
  k_ubench_mul<<<lh::blocks_for(K, S), lh::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (int*)out, K, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_ubench_mul_chain(const void* a, const void* b, void* out,
                                  int R, int K, int S, void* stream) {
  k_ubench_mul_chain<<<lh::blocks_for(K, S), lh::THREADS, 0,
                       (cudaStream_t)stream>>>((const int*)a, (const int*)b,
                                               (int*)out, R, K, S);
  return (int)cudaGetLastError();
}
