// K4: `jac_add_f1`, branchless Jacobian addition (add-2007-bl) over Fp,
// with the structural-infinity selects inside the kernel.
//
// Replaces the reference's Pallas kernel `jac_add_f1`
// (lighthouse_tpu/ops/lane/jacobian.py `_add_f1_body` -> `_add_body`,
// f2=False): 5 squarings, 11 products and 4 light reductions per point pair,
// then P1 = inf ? P2 : (P2 = inf ? P1 : sum), infinity meaning Z has every
// limb exactly 0.
//
// Bound on the H100: integer operations (16 Fp products, ~116,000 int32
// operations per pair, against 1,296 bytes in and out). Design: one thread
// per lane element; about a dozen 36-limb temporaries live in the thread's
// local memory (L1-resident, well past the 255-register limit), each
// product runs out of line with its own limbs in registers (fp_lane.cuh).
// The spill is reported by `nvcc -Xptxas -v`; cutting it (several threads
// per element, shared-memory limbs) is later work.
#include "fp_lane.cuh"

namespace {

using lh::W;

__device__ void add_body(const int* X1, const int* Y1, const int* Z1,
                         const int* X2, const int* Y2, const int* Z2, int* X3,
                         int* Y3, int* Z3) {
  int Z1Z1[W], Z2Z2[W], U1[W], S1[W], H[W], I[W], J[W], r[W], V[W];
  int t[W], u[W];
  lh::fp_sqr(Z1Z1, Z1);
  lh::fp_sqr(Z2Z2, Z2);
  lh::fp_mul(U1, X1, Z2Z2);
  lh::fp_mul(u, X2, Z1Z1);                 // U2
  lh::fp_mul(t, Y1, Z2);
  lh::fp_mul(S1, t, Z2Z2);
  lh::fp_mul(t, Y2, Z1);
  lh::fp_mul(r, t, Z1Z1);                  // S2
  lh::fp_lin2(H, 1, u, -1, U1);            // U2 - U1
  lh::fp_lin2(t, 2, H, 0, H);              // H + H
  lh::fp_sqr(I, t);
  lh::fp_mul(J, H, I);
  lh::fp_lin2(r, 2, r, -2, S1);            // 2 (S2 - S1)
  lh::fp_mul(V, U1, I);
  lh::fp_sqr(u, r);
  lh::fp_lin3(X3, 1, u, -1, J, -2, V);     // S(r) - J - 2 V
  lh::fp_reduce_light(X3);
  lh::fp_lin2(t, 1, V, -1, X3);            // V - X3
  lh::fp_mul(u, r, t);
  lh::fp_mul(t, S1, J);
  lh::fp_lin2(Y3, 1, u, -2, t);            // M(r, V - X3) - 2 M(S1, J)
  lh::fp_reduce_light(Y3);
  lh::fp_lin2(t, 1, Z1, 1, Z2);            // Z1 + Z2
  lh::fp_sqr(u, t);
  lh::fp_lin3(t, 1, u, -1, Z1Z1, -1, Z2Z2);
  lh::fp_reduce_light(t);
  lh::fp_mul(Z3, t, H);
  lh::fp_reduce_light(Z3);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_jac_add_f1(const int* __restrict__ x1, const int* __restrict__ y1,
                 const int* __restrict__ z1, const int* __restrict__ x2,
                 const int* __restrict__ y2, const int* __restrict__ z2,
                 int* __restrict__ ox, int* __restrict__ oy,
                 int* __restrict__ oz, int K, int S) {
  long base;
  if (!lh::elem_index(K, S, &base)) return;
  int X1[W], Y1[W], Z1[W], X2[W], Y2[W], Z2[W], X3[W], Y3[W], Z3[W];
  lh::load_elem(X1, x1, base, S);
  lh::load_elem(Y1, y1, base, S);
  lh::load_elem(Z1, z1, base, S);
  lh::load_elem(X2, x2, base, S);
  lh::load_elem(Y2, y2, base, S);
  lh::load_elem(Z2, z2, base, S);
  add_body(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3);
  // structural-infinity selects (`_add_body`'s `_wh` chain)
  const bool p1_inf = lh::fp_is_zero(Z1);
  const bool p2_inf = lh::fp_is_zero(Z2);
  const int* ox_src = p1_inf ? X2 : (p2_inf ? X1 : X3);
  const int* oy_src = p1_inf ? Y2 : (p2_inf ? Y1 : Y3);
  const int* oz_src = p1_inf ? Z2 : (p2_inf ? Z1 : Z3);
  lh::store_elem(ox, ox_src, base, S);
  lh::store_elem(oy, oy_src, base, S);
  lh::store_elem(oz, oz_src, base, S);
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
