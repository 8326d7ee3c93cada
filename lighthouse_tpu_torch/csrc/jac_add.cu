// K4, K15: `jac_add_f1` and `jac_add_f2`, branchless Jacobian addition
// (add-2007-bl) over Fp (G1) and over Fp2 (G2), with the structural-
// infinity selects inside the kernel; one entry each over `lh::jac_add<F>`
// (jac.cuh).
//
// Replace the reference's Pallas kernels `jac_add_f1` and `jac_add_f2`
// (lighthouse_tpu/ops/lane/jacobian.py:165-166, `_add_f1_body` /
// `_add_f2_body` -> `_add_body`): 5 squarings, 11 products and 4 light
// reductions per point pair, then P1 = inf ? P2 : (P2 = inf ? P1 : sum),
// infinity meaning Z has every limb (of both components over Fp2) exactly 0.
//
// Bound on the H100: integer operations (over Fp 16 Fp products, ~116,000
// int32 operations per pair against 1,296 bytes in and out; over Fp2 43 Fp
// products against 2,592 bytes). Design: one thread per lane element; about
// a dozen field temporaries live in the thread's local memory (L1-resident,
// well past the 255-register limit), the body runs out of line and each
// product in the out-of-line fp_mul with its limbs in registers. The spill
// is reported by `nvcc -Xptxas -v`; cutting it (several threads per
// element, shared-memory limbs) is later work.
#include "jac.cuh"

namespace {

template <class F, int C>
__device__ __forceinline__ void add_entry(const int* x1, const int* y1,
                                          const int* z1, const int* x2,
                                          const int* y2, const int* z2,
                                          int* ox, int* oy, int* oz, int K,
                                          int S) {
  constexpr int N = F::N;
  long k, s;
  if (!lh::lane_index(K, S, &k, &s)) return;
  int X1[N], Y1[N], Z1[N], X2[N], Y2[N], Z2[N], X3[N], Y3[N], Z3[N];
  lh::load_rows<C>(X1, x1, k, s, S);
  lh::load_rows<C>(Y1, y1, k, s, S);
  lh::load_rows<C>(Z1, z1, k, s, S);
  lh::load_rows<C>(X2, x2, k, s, S);
  lh::load_rows<C>(Y2, y2, k, s, S);
  lh::load_rows<C>(Z2, z2, k, s, S);
  lh::jac_add<F>(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3);
  lh::store_rows<C>(ox, X3, k, s, S);
  lh::store_rows<C>(oy, Y3, k, s, S);
  lh::store_rows<C>(oz, Z3, k, s, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_jac_add_f1(const int* __restrict__ x1, const int* __restrict__ y1,
                 const int* __restrict__ z1, const int* __restrict__ x2,
                 const int* __restrict__ y2, const int* __restrict__ z2,
                 int* __restrict__ ox, int* __restrict__ oy,
                 int* __restrict__ oz, int K, int S) {
  add_entry<lh::Fp1, 1>(x1, y1, z1, x2, y2, z2, ox, oy, oz, K, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_jac_add_f2(const int* __restrict__ x1, const int* __restrict__ y1,
                 const int* __restrict__ z1, const int* __restrict__ x2,
                 const int* __restrict__ y2, const int* __restrict__ z2,
                 int* __restrict__ ox, int* __restrict__ oy,
                 int* __restrict__ oz, int K, int S) {
  add_entry<lh::Fp2, 2>(x1, y1, z1, x2, y2, z2, ox, oy, oz, K, S);
}

}  // namespace

LH_EXPORT int lh_jac_add_init(const void* folds, const void* topfm) {
  return lh::copy_consts(folds, topfm);
}

LH_EXPORT const char* lh_jac_add_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_jac_add_f1(const void* x1, const void* y1, const void* z1,
                            const void* x2, const void* y2, const void* z2,
                            void* ox, void* oy, void* oz, int K, int S,
                            void* stream) {
  k_jac_add_f1<<<lh::blocks_for(K, S), lh::THREADS, 0,
                 (cudaStream_t)stream>>>(
      (const int*)x1, (const int*)y1, (const int*)z1, (const int*)x2,
      (const int*)y2, (const int*)z2, (int*)ox, (int*)oy, (int*)oz, K, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_jac_add_f2(const void* x1, const void* y1, const void* z1,
                            const void* x2, const void* y2, const void* z2,
                            void* ox, void* oy, void* oz, int K, int S,
                            void* stream) {
  k_jac_add_f2<<<lh::blocks_for(K, S), lh::THREADS, 0,
                 (cudaStream_t)stream>>>(
      (const int*)x1, (const int*)y1, (const int*)z1, (const int*)x2,
      (const int*)y2, (const int*)z2, (int*)ox, (int*)oy, (int*)oz, K, S);
  return (int)cudaGetLastError();
}
