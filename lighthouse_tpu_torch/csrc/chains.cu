// K18, K19: `g1_win_step` and `g2_win_step`, one window of the 2-bit
// windowed scalar ladder (ops/lane/chains.py `scalar_mul_w2`) over G1 and
// over G2: acc <- [4]acc + T[digit], one entry each over `lh::win_step<F>`
// (jac.cuh).
//
// Replace the reference's Pallas kernels `g1_win_step` and `g2_win_step`
// (lighthouse_tpu/ops/lane/chains.py:137-138, `_win_step_body`): two
// doublings of the accumulator, the 3-way select of T1/T2/T3 by the lane's
// digit, one branchless add (computed on every lane, as the body does) and
// the digit-0 pass-through of the doubled accumulator.
//
// Their own library rather than the jac ones: the three libraries build in
// parallel (one nvcc each), and the window step, the largest of the group
// kernels, would otherwise lengthen one of the jac builds.
//
// Bound on the H100: integer operations (over Fp 2 x 7 + 16 = 30 Fp
// products per lane, ~220,000 int32 operations, against 12 points + 1
// digit in and one point out, ~5.6 KB; over Fp2 2 x 16 + 43 = 75 Fp
// products against ~11 KB). Design: one thread per lane element; the
// accumulator, the table and the temporaries of the dbl and add bodies live
// in the thread's local memory; the digit is one int32 per lane ([K, 1, S]),
// not a field element.
#include "jac.cuh"

namespace {

template <class F, int C>
__device__ __forceinline__ void win_entry(const int* const* in, const int* dig,
                                          int* ox, int* oy, int* oz, int K,
                                          int S) {
  constexpr int N = F::N;
  long k, s;
  if (!lh::lane_index(K, S, &k, &s)) return;
  // acc, T1, T2, T3: three coordinates each, back to back
  int pts[4][3 * N];
#pragma unroll 1
  for (int p = 0; p < 4; ++p) {
#pragma unroll 1
    for (int c = 0; c < 3; ++c) lh::load_rows<C>(pts[p] + c * N, in[3 * p + c], k, s, S);
  }
  const int d = dig[k * S + s];
  lh::win_step<F>(pts[0], pts[1], pts[2], pts[3], d, pts[0]);
  lh::store_rows<C>(ox, pts[0], k, s, S);
  lh::store_rows<C>(oy, pts[0] + N, k, s, S);
  lh::store_rows<C>(oz, pts[0] + 2 * N, k, s, S);
}

// the 12 coordinate operands travel by value in one struct
struct Coords {
  const int* p[12];
};

__global__ void __launch_bounds__(lh::THREADS)
    k_g1_win_step(Coords in, const int* __restrict__ dig, int* __restrict__ ox,
                  int* __restrict__ oy, int* __restrict__ oz, int K, int S) {
  win_entry<lh::Fp1, 1>(in.p, dig, ox, oy, oz, K, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_g2_win_step(Coords in, const int* __restrict__ dig, int* __restrict__ ox,
                  int* __restrict__ oy, int* __restrict__ oz, int K, int S) {
  win_entry<lh::Fp2, 2>(in.p, dig, ox, oy, oz, K, S);
}

Coords coords(const void* const* a) {
  Coords c;
  for (int i = 0; i < 12; ++i) c.p[i] = (const int*)a[i];
  return c;
}

}  // namespace

LH_EXPORT int lh_chains_init(const void* folds, const void* topfm) {
  return lh::copy_consts(folds, topfm);
}

LH_EXPORT const char* lh_chains_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// operands: Xa, Ya, Za, X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, dig; outputs
// X, Y, Z
#define LH_WIN_ARGS                                                         \
  const void *xa, const void *ya, const void *za, const void *x1,           \
      const void *y1, const void *z1, const void *x2, const void *y2,       \
      const void *z2, const void *x3, const void *y3, const void *z3,       \
      const void *dig, void *ox, void *oy, void *oz, int K, int S,          \
      void *stream

LH_EXPORT int lh_g1_win_step(LH_WIN_ARGS) {
  const void* a[12] = {xa, ya, za, x1, y1, z1, x2, y2, z2, x3, y3, z3};
  k_g1_win_step<<<lh::blocks_for(K, S), lh::THREADS, 0,
                  (cudaStream_t)stream>>>(coords(a), (const int*)dig,
                                          (int*)ox, (int*)oy, (int*)oz, K, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_g2_win_step(LH_WIN_ARGS) {
  const void* a[12] = {xa, ya, za, x1, y1, z1, x2, y2, z2, x3, y3, z3};
  k_g2_win_step<<<lh::blocks_for(K, S), lh::THREADS, 0,
                  (cudaStream_t)stream>>>(coords(a), (const int*)dig,
                                          (int*)ox, (int*)oy, (int*)oz, K, S);
  return (int)cudaGetLastError();
}
