// Jacobian group operations over Fp (G1) and Fp2 (G2) as CUDA device
// functions, one thread per lane element: the device half of the bodies of
// lighthouse_tpu_torch/ops/lane/jacobian.py (`_dbl_body`, `_add_body`) for
// the one-thread ladder steps (ladder.cu `ladder_step_f1`, `ladder_step_f2`).
//
// The bodies are written once, templated on the field, as the reference's
// are generic over its `f2` flag:
//   Fp1 - a lane element is W limbs; S/M are `_sqr_fn`/`_mul_fn`
//         (fp_sqr / fp_mul of fp_lane.cuh);
//   Fp2 - a lane element is 2 x W limbs (c0, c1); S/M are `_f2sqr_body`/
//         `_f2mul_body` (f2sqr / f2mul of tower.cuh).
// RL is `_reduce_light_body` on every Fp row of the element. Each body makes
// the same products, in the same places, as its PyTorch version; the lazy
// sums between them are limb-wise integer combinations, so their order
// does not change the integers.
//
// The dbl and add bodies are out of line (`__noinline__`): each keeps one
// copy of its code, and its temporaries in its own stack frame.
#pragma once

#include "tower.cuh"

namespace lh {

struct Fp1 {
  static constexpr int N = W;
  static __device__ __forceinline__ void sqr(int* o, const int* a) { fp_sqr(o, a); }
  static __device__ __forceinline__ void mul(int* o, const int* a, const int* b) {
    fp_mul(o, a, b);
  }
  static __device__ __forceinline__ void rl(int* x) { fp_reduce_light(x); }
};

struct Fp2 {
  static constexpr int N = F2;
  static __device__ __forceinline__ void sqr(int* o, const int* a) { f2sqr(o, a); }
  static __device__ __forceinline__ void mul(int* o, const int* a, const int* b) {
    f2mul(o, a, b);
  }
  static __device__ __forceinline__ void rl(int* x) { f2_reduce_light(x); }
};

// structural infinity (`_is_zero`): every limb of every component exactly 0
template <int N>
__device__ __forceinline__ bool is_zero_n(const int* a) {
  int acc = 0;
#pragma unroll 8
  for (int i = 0; i < N; ++i) acc |= a[i];
  return acc == 0;
}

// `_dbl_body`: dbl-2009-l. Outputs may not alias the inputs.
template <class F>
__device__ __noinline__ void jac_dbl(const int* X, const int* Y, const int* Z,
                                     int* X3, int* Y3, int* Z3) {
  constexpr int N = F::N;
  int A[N], Bv[N], Cv[N], D[N], E[N], t[N], u[N];
  F::sqr(A, X);
  F::sqr(Bv, Y);
  F::sqr(Cv, Bv);
  lin2<N>(t, 1, X, 1, Bv);              // X + B
  F::sqr(u, t);
  lin3<N>(D, 1, u, -1, A, -1, Cv);      // S(X + B) - A - C
  F::rl(D);
  lin2<N>(D, 1, D, 1, D);               // D + D
  lin2<N>(E, 3, A, 0, A);               // A + A + A
  F::sqr(u, E);                         // F
  lin2<N>(X3, 1, u, -2, D);             // F - D - D
  F::rl(X3);
  lin2<N>(t, 1, D, -1, X3);             // D - X3
  F::mul(u, E, t);
  lin2<N>(Y3, 1, u, -8, Cv);            // M(E, D - X3) - 8 C
  F::rl(Y3);
  F::mul(u, Y, Z);
  lin2<N>(Z3, 2, u, 0, u);              // 2 M(Y, Z)
  F::rl(Z3);
}

// `_add_body`: add-2007-bl, then the structural-infinity selects
// P1 = inf ? P2 : (P2 = inf ? P1 : sum). Outputs may not alias the inputs.
template <class F>
__device__ __noinline__ void jac_add(const int* X1, const int* Y1,
                                     const int* Z1, const int* X2,
                                     const int* Y2, const int* Z2, int* X3,
                                     int* Y3, int* Z3) {
  constexpr int N = F::N;
  int Z1Z1[N], Z2Z2[N], U1[N], S1[N], H[N], I[N], J[N], r[N], V[N];
  int t[N], u[N];
  F::sqr(Z1Z1, Z1);
  F::sqr(Z2Z2, Z2);
  F::mul(U1, X1, Z2Z2);
  F::mul(u, X2, Z1Z1);                  // U2
  F::mul(t, Y1, Z2);
  F::mul(S1, t, Z2Z2);
  F::mul(t, Y2, Z1);
  F::mul(r, t, Z1Z1);                   // S2
  lin2<N>(H, 1, u, -1, U1);             // U2 - U1
  lin2<N>(t, 2, H, 0, H);               // H + H
  F::sqr(I, t);
  F::mul(J, H, I);
  lin2<N>(r, 2, r, -2, S1);             // 2 (S2 - S1)
  F::mul(V, U1, I);
  F::sqr(u, r);
  lin3<N>(X3, 1, u, -1, J, -2, V);      // S(r) - J - 2 V
  F::rl(X3);
  lin2<N>(t, 1, V, -1, X3);             // V - X3
  F::mul(u, r, t);
  F::mul(t, S1, J);
  lin2<N>(Y3, 1, u, -2, t);             // M(r, V - X3) - 2 M(S1, J)
  F::rl(Y3);
  lin2<N>(t, 1, Z1, 1, Z2);             // Z1 + Z2
  F::sqr(u, t);
  lin3<N>(t, 1, u, -1, Z1Z1, -1, Z2Z2);
  F::rl(t);
  F::mul(Z3, t, H);
  F::rl(Z3);
  const bool p1_inf = is_zero_n<N>(Z1);
  const bool p2_inf = is_zero_n<N>(Z2);
  if (p1_inf || p2_inf) {
    const int* src_x = p1_inf ? X2 : X1;
    const int* src_y = p1_inf ? Y2 : Y1;
    const int* src_z = p1_inf ? Z2 : Z1;
    copy_n<N>(X3, src_x);
    copy_n<N>(Y3, src_y);
    copy_n<N>(Z3, src_z);
  }
}

}  // namespace lh
