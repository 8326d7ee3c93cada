// K1: Fp product `mul`, and `sqr` from the same body in sqr mode
// (two entries, k_mul and k_sqr, over one templated body).
//
// Replaces the Pallas kernels `mul` and `sqr` of the reference
// (lighthouse_tpu/ops/lane/fp.py `_mul_fn` / `_sqr_fn` -> `_mul_body`,
// registered through `kernel_op`'s pl.pallas_call).
//
// Bound on the H100: integer operations. Per element the kernel reads 2
// (sqr: 1) x 144 bytes and writes 144, but does 1,296 conv multiply-adds,
// 1,476 fold multiply-adds and ~330 limb carry steps: some 7,300 int32
// operations for 432 bytes, far above the card's ops-per-byte balance.
// Design: one thread per lane element, all limbs in registers (a, b and the
// 73-limb accumulator, ~150 live values), the fold matrices in constant
// memory (one broadcast read per warp), coalesced loads (neighbouring
// threads hold neighbouring lanes). No shared memory and no tiling: a
// simple first version; several threads per element is later work.
#include "fp_lane.cuh"

namespace {

template <bool SQR>
__device__ __forceinline__ void mul_elem(const int* __restrict__ a,
                                         const int* __restrict__ b,
                                         int* __restrict__ out, int K, int S) {
  long base;
  if (!lh::elem_index(K, S, &base)) return;
  int x[lh::W], r[lh::W];
  lh::load_elem(x, a, base, S);
  if (SQR) {
    lh::sqr_body(r, x);
  } else {
    int y[lh::W];
    lh::load_elem(y, b, base, S);
    lh::mul_body<true, true>(r, x, y);
  }
  lh::store_elem(out, r, base, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_mul(const int* __restrict__ a, const int* __restrict__ b,
          int* __restrict__ out, int K, int S) {
  mul_elem<false>(a, b, out, K, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_sqr(const int* __restrict__ a, int* __restrict__ out, int K, int S) {
  mul_elem<true>(a, nullptr, out, K, S);
}

}  // namespace

LH_EXPORT int lh_fp_mul_init(const void* folds, const void* topfm) {
  return lh::copy_consts(folds, topfm);
}

LH_EXPORT const char* lh_fp_mul_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_fp_mul(const void* a, const void* b, void* out, int K, int S,
                        void* stream) {
  k_mul<<<lh::blocks_for(K, S), lh::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (int*)out, K, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_fp_sqr(const void* a, void* out, int K, int S, void* stream) {
  k_sqr<<<lh::blocks_for(K, S), lh::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)a, (int*)out, K, S);
  return (int)cudaGetLastError();
}
