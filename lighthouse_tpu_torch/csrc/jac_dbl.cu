// K3: `jac_dbl_f1`, Jacobian doubling (dbl-2009-l) over Fp.
//
// Replaces the reference's Pallas kernel `jac_dbl_f1`
// (lighthouse_tpu/ops/lane/jacobian.py `_dbl_f1_body` -> `_dbl_body`,
// f2=False): 5 squarings, 2 products and 3 light reductions per point.
//
// Bound on the H100: integer operations (7 Fp products, ~50,000 int32
// operations per point, against 864 bytes in and out). Design: one thread
// per lane element; the coordinates and temporaries live in the thread's
// local memory (L1-resident) and each product runs out of line with its
// own limbs in registers (fp_mul / fp_sqr in fp_lane.cuh), so the code
// holds one copy of the product. The spill this costs is reported by
// `nvcc -Xptxas -v` at build time.
#include "fp_lane.cuh"

namespace {

using lh::W;

__device__ void dbl_body(const int* X, const int* Y, const int* Z, int* X3,
                         int* Y3, int* Z3) {
  int A[W], Bv[W], Cv[W], D[W], E[W], t[W], u[W];
  lh::fp_sqr(A, X);
  lh::fp_sqr(Bv, Y);
  lh::fp_sqr(Cv, Bv);
  lh::fp_lin2(t, 1, X, 1, Bv);            // X + B
  lh::fp_sqr(u, t);
  lh::fp_lin3(D, 1, u, -1, A, -1, Cv);    // S(X + B) - A - C
  lh::fp_reduce_light(D);
  lh::fp_lin2(D, 1, D, 1, D);             // D + D
  lh::fp_lin2(E, 3, A, 0, A);             // A + A + A
  lh::fp_sqr(u, E);                       // F
  lh::fp_lin2(X3, 1, u, -2, D);           // F - D - D
  lh::fp_reduce_light(X3);
  lh::fp_lin2(t, 1, D, -1, X3);           // D - X3
  lh::fp_mul(u, E, t);
  lh::fp_lin2(Y3, 1, u, -8, Cv);          // M(E, D - X3) - 8 C
  lh::fp_reduce_light(Y3);
  lh::fp_mul(u, Y, Z);
  lh::fp_lin2(Z3, 2, u, 0, u);            // 2 M(Y, Z)
  lh::fp_reduce_light(Z3);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_jac_dbl_f1(const int* __restrict__ x, const int* __restrict__ y,
                 const int* __restrict__ z, int* __restrict__ ox,
                 int* __restrict__ oy, int* __restrict__ oz, int K, int S) {
  long base;
  if (!lh::elem_index(K, S, &base)) return;
  int X[W], Y[W], Z[W], X3[W], Y3[W], Z3[W];
  lh::load_elem(X, x, base, S);
  lh::load_elem(Y, y, base, S);
  lh::load_elem(Z, z, base, S);
  dbl_body(X, Y, Z, X3, Y3, Z3);
  lh::store_elem(ox, X3, base, S);
  lh::store_elem(oy, Y3, base, S);
  lh::store_elem(oz, Z3, base, S);
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
