// K3, K14: `jac_dbl_f1` and `jac_dbl_f2`, Jacobian doubling (dbl-2009-l)
// over Fp (G1) and over Fp2 (G2), one entry each over `lh::jac_dbl<F>`
// (jac.cuh).
//
// Replace the reference's Pallas kernels `jac_dbl_f1` and `jac_dbl_f2`
// (lighthouse_tpu/ops/lane/jacobian.py:163-164, `_dbl_f1_body` /
// `_dbl_f2_body` -> `_dbl_body`): 5 squarings, 2 products and 3 light
// reductions per point, in the field of the point.
//
// Bound on the H100: integer operations (over Fp 7 Fp products, ~50,000
// int32 operations per point against 864 bytes in and out; over Fp2 each
// square is 2 and each product 3 Fp products, 16 in all, against 1,728
// bytes). Design: one thread per lane element; the coordinates and
// temporaries live in the thread's local memory (L1-resident), the body runs
// out of line and each product in the out-of-line fp_mul with its limbs in
// registers, so the code holds one copy of the product. The spill this costs
// is reported by `nvcc -Xptxas -v` at build time.
#include "jac.cuh"

namespace {

template <class F, int C>
__device__ __forceinline__ void dbl_entry(const int* x, const int* y,
                                          const int* z, int* ox, int* oy,
                                          int* oz, int K, int S) {
  constexpr int N = F::N;
  long k, s;
  if (!lh::lane_index(K, S, &k, &s)) return;
  int X[N], Y[N], Z[N], X3[N], Y3[N], Z3[N];
  lh::load_rows<C>(X, x, k, s, S);
  lh::load_rows<C>(Y, y, k, s, S);
  lh::load_rows<C>(Z, z, k, s, S);
  lh::jac_dbl<F>(X, Y, Z, X3, Y3, Z3);
  lh::store_rows<C>(ox, X3, k, s, S);
  lh::store_rows<C>(oy, Y3, k, s, S);
  lh::store_rows<C>(oz, Z3, k, s, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_jac_dbl_f1(const int* __restrict__ x, const int* __restrict__ y,
                 const int* __restrict__ z, int* __restrict__ ox,
                 int* __restrict__ oy, int* __restrict__ oz, int K, int S) {
  dbl_entry<lh::Fp1, 1>(x, y, z, ox, oy, oz, K, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_jac_dbl_f2(const int* __restrict__ x, const int* __restrict__ y,
                 const int* __restrict__ z, int* __restrict__ ox,
                 int* __restrict__ oy, int* __restrict__ oz, int K, int S) {
  dbl_entry<lh::Fp2, 2>(x, y, z, ox, oy, oz, K, S);
}

}  // namespace

LH_EXPORT int lh_jac_dbl_init(const void* folds, const void* topfm) {
  return lh::copy_consts(folds, topfm);
}

LH_EXPORT const char* lh_jac_dbl_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_jac_dbl_f1(const void* x, const void* y, const void* z,
                            void* ox, void* oy, void* oz, int K, int S,
                            void* stream) {
  k_jac_dbl_f1<<<lh::blocks_for(K, S), lh::THREADS, 0,
                 (cudaStream_t)stream>>>((const int*)x, (const int*)y,
                                         (const int*)z, (int*)ox, (int*)oy,
                                         (int*)oz, K, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_jac_dbl_f2(const void* x, const void* y, const void* z,
                            void* ox, void* oy, void* oz, int K, int S,
                            void* stream) {
  k_jac_dbl_f2<<<lh::blocks_for(K, S), lh::THREADS, 0,
                 (cudaStream_t)stream>>>((const int*)x, (const int*)y,
                                         (const int*)z, (int*)ox, (int*)oy,
                                         (int*)oz, K, S);
  return (int)cudaGetLastError();
}
