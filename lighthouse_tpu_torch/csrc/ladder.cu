// K16, K17: `ladder_step_f1` and `ladder_step_f2`, one step of the per-lane
// dynamic scalar ladder (ops/lane/jacobian.py `scalar_mul`,
// `scalar_mul_with_static`) over G1 and over G2, one entry each over
// `lh::jac_add<F>` and `lh::jac_dbl<F>` (jac.cuh).
//
// Replace the reference's Pallas kernels `ladder_step_f1` and
// `ladder_step_f2` (lighthouse_tpu/ops/lane/jacobian.py:167-168,
// `_ladder_step_body`): the branchless add of the addend into the
// accumulator, computed on every lane as the body does and kept on the
// lanes whose bit is set, and the doubling of the addend. Six coordinates in
// (accumulator, addend) plus the bit row, six out (accumulator, doubled
// addend).
//
// Bound on the H100: integer operations (over Fp 16 + 7 = 23 Fp products
// per lane, ~170,000 int32 operations, against 12 Fp elements and a bit in
// and 6 out, ~2.6 KB; over Fp2 43 + 16 = 59 Fp products against ~5.2 KB).
// Design: one thread per lane element; both points and the results live in
// the thread's local memory, the add and the doubling run in their
// out-of-line bodies (one stack frame at a time); the bit is one int32 per
// lane ([K, 1, S]), read the way the window step reads its digit.
#include "jac.cuh"

namespace {

template <class F, int C>
__device__ __forceinline__ void step_entry(const int* const* in, const int* bit,
                                           int* const* out, int K, int S) {
  constexpr int N = F::N;
  long k, s;
  if (!lh::lane_index(K, S, &k, &s)) return;
  // accumulator, addend: three coordinates each, back to back
  int pts[2][3 * N];
#pragma unroll 1
  for (int p = 0; p < 2; ++p) {
#pragma unroll 1
    for (int c = 0; c < 3; ++c) lh::load_rows<C>(pts[p] + c * N, in[3 * p + c], k, s, S);
  }
  int res[3 * N];
  const int* acc = pts[0];
  const int* ad = pts[1];
  lh::jac_add<F>(acc, acc + N, acc + 2 * N, ad, ad + N, ad + 2 * N, res,
                 res + N, res + 2 * N);
  if (bit[k * S + s] == 0) lh::copy_n<3 * N>(res, acc);
#pragma unroll 1
  for (int c = 0; c < 3; ++c) lh::store_rows<C>(out[c], res + c * N, k, s, S);
  lh::jac_dbl<F>(ad, ad + N, ad + 2 * N, res, res + N, res + 2 * N);
#pragma unroll 1
  for (int c = 0; c < 3; ++c) lh::store_rows<C>(out[3 + c], res + c * N, k, s, S);
}

// the 6 coordinate operands and the 6 outputs travel by value in one struct
struct Coords {
  const int* in[6];
  int* out[6];
};

__global__ void __launch_bounds__(lh::THREADS)
    k_ladder_step_f1(Coords c, const int* __restrict__ bit, int K, int S) {
  step_entry<lh::Fp1, 1>(c.in, bit, c.out, K, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_ladder_step_f2(Coords c, const int* __restrict__ bit, int K, int S) {
  step_entry<lh::Fp2, 2>(c.in, bit, c.out, K, S);
}

Coords coords(const void* const* in, void* const* out) {
  Coords c;
  for (int i = 0; i < 6; ++i) {
    c.in[i] = (const int*)in[i];
    c.out[i] = (int*)out[i];
  }
  return c;
}

}  // namespace

LH_EXPORT int lh_ladder_init(const void* folds, const void* topfm) {
  return lh::copy_consts(folds, topfm);
}

LH_EXPORT const char* lh_ladder_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// operands: X1, Y1, Z1 (accumulator), Xa, Ya, Za (addend), bit; outputs
// X, Y, Z (accumulator), Xd, Yd, Zd (doubled addend)
#define LH_STEP_ARGS                                                        \
  const void *x1, const void *y1, const void *z1, const void *xa,           \
      const void *ya, const void *za, const void *bit, void *ox, void *oy,  \
      void *oz, void *oxd, void *oyd, void *ozd, int K, int S, void *stream

LH_EXPORT int lh_ladder_step_f1(LH_STEP_ARGS) {
  const void* in[6] = {x1, y1, z1, xa, ya, za};
  void* out[6] = {ox, oy, oz, oxd, oyd, ozd};
  k_ladder_step_f1<<<lh::blocks_for(K, S), lh::THREADS, 0,
                     (cudaStream_t)stream>>>(coords(in, out), (const int*)bit, K, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_ladder_step_f2(LH_STEP_ARGS) {
  const void* in[6] = {x1, y1, z1, xa, ya, za};
  void* out[6] = {ox, oy, oz, oxd, oyd, ozd};
  k_ladder_step_f2<<<lh::blocks_for(K, S), lh::THREADS, 0,
                     (cudaStream_t)stream>>>(coords(in, out), (const int*)bit, K, S);
  return (int)cudaGetLastError();
}
