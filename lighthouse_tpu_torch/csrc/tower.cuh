// The Fp2/Fp6/Fp12 tower as CUDA device functions, one thread per lane
// element, over the Fp product of fp_lane.cuh.
//
// The device half of lighthouse_tpu_torch/ops/lane/tower.py. A lane
// element lives in the thread's local memory as consecutive Fp limb rows:
// Fp2 [2][W] (c0, c1), Fp6 [3][2][W], Fp12 [2][3][2][W], the order of the
// [..., comp, W, S] tensors. Each function mirrors one plain body: the
// same Fp products (`fp_mul` with both entry norms wherever the body calls
// `_mul_body`, also for f2sqr), `reduce_light` exactly where the body puts
// it, and the same lazy sums. A lazy sum is a linear combination of int32
// limbs, so any order of its adds gives the body's integers; the
// limb-bounds certificate (tests/budgets/limb_bounds.json) keeps every
// value in int32.
//
// The tower levels are out-of-line functions that loop over their stacks
// (`#pragma unroll 1`): each keeps one copy of its code, its temporaries in
// its own stack frame, and calls the out-of-line `fp_mul`.
#pragma once

#include "fp_lane.cuh"

namespace lh {

constexpr int F2 = 2 * W;    // limbs of one Fp2
constexpr int F6 = 3 * F2;   // of one Fp6
constexpr int F12 = 2 * F6;  // of one Fp12

// ---------------------------------------------------------- lazy sums
template <int N>
__device__ __forceinline__ void copy_n(int* out, const int* a) {
#pragma unroll 8
  for (int i = 0; i < N; ++i) out[i] = a[i];
}

// out = ca*a + cb*b, limb by limb (out may be a or b)
template <int N>
__device__ __forceinline__ void lin2(int* out, int ca, const int* a, int cb,
                                     const int* b) {
#pragma unroll 8
  for (int i = 0; i < N; ++i) out[i] = ca * a[i] + cb * b[i];
}

// out = ca*a + cb*b + cc*c
template <int N>
__device__ __forceinline__ void lin3(int* out, int ca, const int* a, int cb,
                                     const int* b, int cc, const int* c) {
#pragma unroll 8
  for (int i = 0; i < N; ++i) out[i] = ca * a[i] + cb * b[i] + cc * c[i];
}

// `_reduce_light_body` on each Fp row of an Fp2
__device__ __forceinline__ void f2_reduce_light(int* x) {
  fp_reduce_light(x);
  fp_reduce_light(x + W);
}

// ---------------------------------------------------------- Fp2
// `_f2mul_body`: Karatsuba, products a0 b0, a1 b1, (a0+a1)(b0+b1);
// c0 = t0 - t1, c1 = t2 - t0 - t1; reduce_light. out may alias a or b.
__device__ __noinline__ void f2mul(int* out, const int* a, const int* b) {
  int t[3 * W], x[W], y[W];
  fp_mul(t, a, b);
  fp_mul(t + W, a + W, b + W);
  lin2<W>(x, 1, a, 1, a + W);
  lin2<W>(y, 1, b, 1, b + W);
  fp_mul(t + 2 * W, x, y);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    out[i] = t[i] - t[W + i];
    out[W + i] = t[2 * W + i] - t[i] - t[W + i];
  }
  f2_reduce_light(out);
}

// `_f2sqr_body`: c0 = (a0+a1)(a0-a1), c1 = a0 (a1+a1), through the full
// product with both entry norms (not `_sqr_fn`); no reduce_light.
__device__ __noinline__ void f2sqr(int* out, const int* a) {
  int t[F2], x[W], y[W];
  lin2<W>(x, 1, a, 1, a + W);
  lin2<W>(y, 1, a, -1, a + W);
  fp_mul(t, x, y);
  lin2<W>(y, 1, a + W, 1, a + W);
  fp_mul(t + W, a, y);
  copy_n<F2>(out, t);
}

// `f2mul_xi` of a Fp2 given as its two limbs: (a0 - a1, a0 + a1)
#define LH_XI0(a0, a1) ((a0) - (a1))
#define LH_XI1(a0, a1) ((a0) + (a1))

// ---------------------------------------------------------- Fp6
// `_f6mul_body`: the six Fp2 products t0 = a0 b0, t1 = a1 b1, t2 = a2 b2,
// u01 = (a0+a1)(b0+b1), u02 = (a0+a2)(b0+b2), u12 = (a1+a2)(b1+b2), then
// c0 = t0 + xi(u12 - t1 - t2), c1 = u01 - t0 - t1 + xi(t2),
// c2 = u02 - t0 - t2 + t1; reduce_light. out may alias a or b.
__device__ __noinline__ void f6mul(int* out, const int* a, const int* b) {
  int t[6 * F2], x[F2], y[F2];
#pragma unroll 1
  for (int k = 0; k < 6; ++k) {
    if (k < 3) {
      f2mul(t + k * F2, a + k * F2, b + k * F2);
    } else {
      const int i = k == 5 ? 1 : 0;
      const int j = k == 3 ? 1 : 2;
      lin2<F2>(x, 1, a + i * F2, 1, a + j * F2);
      lin2<F2>(y, 1, b + i * F2, 1, b + j * F2);
      f2mul(t + k * F2, x, y);
    }
  }
#pragma unroll 4
  for (int i = 0; i < W; ++i) {
#define T(k, c) t[(k) * F2 + (c) * W + i]
    const int d0 = T(5, 0) - T(1, 0) - T(2, 0);
    const int d1 = T(5, 1) - T(1, 1) - T(2, 1);
    out[0 * W + i] = T(0, 0) + LH_XI0(d0, d1);
    out[1 * W + i] = T(0, 1) + LH_XI1(d0, d1);
    out[2 * W + i] = T(3, 0) - T(0, 0) - T(1, 0) + LH_XI0(T(2, 0), T(2, 1));
    out[3 * W + i] = T(3, 1) - T(0, 1) - T(1, 1) + LH_XI1(T(2, 0), T(2, 1));
    out[4 * W + i] = T(4, 0) - T(0, 0) - T(2, 0) + T(1, 0);
    out[5 * W + i] = T(4, 1) - T(0, 1) - T(2, 1) + T(1, 1);
#undef T
  }
#pragma unroll 1
  for (int c = 0; c < 6; ++c) fp_reduce_light(out + c * W);
}

// ---------------------------------------------------------- Fp12
// `_f12sqr_body`: m = (a0 + a1)(a0 + v a1), n = a0 a1 (Fp6);
// c0 = m - n - v n, c1 = n + n. Lazy (<= 4-unit) output. out may alias a.
__device__ __noinline__ void f12sqr(int* out, const int* a) {
  int m[F6], n[F6], x[F6], y[F6];
  const int* a1 = a + F6;
#pragma unroll 4
  for (int i = 0; i < W; ++i) {
#pragma unroll
    for (int r = 0; r < 6; ++r) x[r * W + i] = a[r * W + i] + a1[r * W + i];
    y[0 * W + i] = a[0 * W + i] + LH_XI0(a1[4 * W + i], a1[5 * W + i]);
    y[1 * W + i] = a[1 * W + i] + LH_XI1(a1[4 * W + i], a1[5 * W + i]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      y[(2 + c) * W + i] = a[(2 + c) * W + i] + a1[c * W + i];
      y[(4 + c) * W + i] = a[(4 + c) * W + i] + a1[(2 + c) * W + i];
    }
  }
  f6mul(m, x, y);
  f6mul(n, a, a1);
#pragma unroll 4
  for (int i = 0; i < W; ++i) {
    out[0 * W + i] = m[0 * W + i] - n[0 * W + i] - LH_XI0(n[4 * W + i], n[5 * W + i]);
    out[1 * W + i] = m[1 * W + i] - n[1 * W + i] - LH_XI1(n[4 * W + i], n[5 * W + i]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      out[(2 + c) * W + i] = m[(2 + c) * W + i] - n[(2 + c) * W + i] - n[c * W + i];
      out[(4 + c) * W + i] = m[(4 + c) * W + i] - n[(4 + c) * W + i] - n[(2 + c) * W + i];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) out[F6 + r * W + i] = n[r * W + i] + n[r * W + i];
  }
}

// `_f12mul_034_body`: f (c0 + c1 v + c4 v w), thirteen Fp2 products of
// g0 = (x0, x1, x2), g1 = (y0, y1, y2), with d = c1 + c4:
//   m00 = x0 c0, m11 = x1 c1, m01k = (x0+x1)(c0+c1), m20 = x2 c0, m21 = x2 c1,
//   n0 = y0 c4, n1 = y1 c4, n2 = y2 c4,
//   s00 = (x0+y0) c0, s11 = (x1+y1) d, s01k = ((x0+y0)+(x1+y1))(c0+d),
//   s20 = (x2+y2) c0, s21 = (x2+y2) d;
// t0 = (m00 + xi m21, m01k - m00 - m11, m11 + m20), t1 = (xi n2, n0, n1),
// ts = (s00 + xi s21, s01k - s00 - s11, s11 + s20);
// out = (t0 + v t1, ts - t0 - t1). Lazy (<= 3-unit). out may alias f.
__device__ __noinline__ void f12mul_034(int* out, const int* f, const int* c0,
                                        const int* c1, const int* c4) {
  int p[13 * F2], x[F2], y[F2], d[F2];
  const int* x0 = f;
  const int* x1 = f + F2;
  const int* x2 = f + 2 * F2;
  const int* y0 = f + F6;
  const int* y1 = f + F6 + F2;
  const int* y2 = f + F6 + 2 * F2;
  lin2<F2>(d, 1, c1, 1, c4);
  f2mul(p + 0 * F2, x0, c0);
  f2mul(p + 1 * F2, x1, c1);
  lin2<F2>(x, 1, x0, 1, x1);
  lin2<F2>(y, 1, c0, 1, c1);
  f2mul(p + 2 * F2, x, y);
  f2mul(p + 3 * F2, x2, c0);
  f2mul(p + 4 * F2, x2, c1);
  f2mul(p + 5 * F2, y0, c4);
  f2mul(p + 6 * F2, y1, c4);
  f2mul(p + 7 * F2, y2, c4);
  lin2<F2>(x, 1, x0, 1, y0);
  f2mul(p + 8 * F2, x, c0);
  lin2<F2>(y, 1, x1, 1, y1);
  f2mul(p + 9 * F2, y, d);
  lin2<F2>(x, 1, x, 1, y);              // (x0 + y0) + (x1 + y1)
  lin2<F2>(y, 1, c0, 1, d);
  f2mul(p + 10 * F2, x, y);
  lin2<F2>(x, 1, x2, 1, y2);
  f2mul(p + 11 * F2, x, c0);
  f2mul(p + 12 * F2, x, d);
#pragma unroll 2
  for (int i = 0; i < W; ++i) {
#define R(k, c) p[(k) * F2 + (c) * W + i]
    int t0[6], t1[6], ts[6];  // [m * 2 + c]
    t0[0] = R(0, 0) + LH_XI0(R(4, 0), R(4, 1));
    t0[1] = R(0, 1) + LH_XI1(R(4, 0), R(4, 1));
    t1[0] = LH_XI0(R(7, 0), R(7, 1));
    t1[1] = LH_XI1(R(7, 0), R(7, 1));
    ts[0] = R(8, 0) + LH_XI0(R(12, 0), R(12, 1));
    ts[1] = R(8, 1) + LH_XI1(R(12, 0), R(12, 1));
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      t0[2 + c] = R(2, c) - R(0, c) - R(1, c);
      t0[4 + c] = R(1, c) + R(3, c);
      t1[2 + c] = R(5, c);
      t1[4 + c] = R(6, c);
      ts[2 + c] = R(10, c) - R(8, c) - R(9, c);
      ts[4 + c] = R(9, c) + R(11, c);
    }
#undef R
    out[0 * W + i] = t0[0] + LH_XI0(t1[4], t1[5]);
    out[1 * W + i] = t0[1] + LH_XI1(t1[4], t1[5]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      out[(2 + c) * W + i] = t0[2 + c] + t1[c];
      out[(4 + c) * W + i] = t0[4 + c] + t1[2 + c];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) out[F6 + r * W + i] = ts[r] - t0[r] - t1[r];
  }
}

// ---------------------------------------------------------- global I/O
// Thread -> (k, s) of a K x S grid of lane elements; false past the edge.
__device__ __forceinline__ bool lane_index(int K, int S, long* k, long* s) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)K * S) return false;
  *k = t / S;
  *s = t - *k * S;
  return true;
}

// Element (k, s) of a [K, C rows of W, S] batch: limb row r at
// ((k*C*W + r) * S + s); C = 1, 2, 6, 12 for Fp, Fp2, Fp6, Fp12.
template <int C>
__device__ __forceinline__ void load_rows(int* out, const int* __restrict__ g,
                                          long k, long s, int S) {
  const long base = k * C * W * S + s;
#pragma unroll 4
  for (int r = 0; r < C * W; ++r) out[r] = g[base + (long)r * S];
}

template <int C>
__device__ __forceinline__ void store_rows(int* __restrict__ g, const int* v,
                                           long k, long s, int S) {
  const long base = k * C * W * S + s;
#pragma unroll 4
  for (int r = 0; r < C * W; ++r) g[base + (long)r * S] = v[r];
}

}  // namespace lh
