// K10, K11, K12: the pairing kernels, the fused Miller-loop iterations
// `miller_dbl_iter` and `miller_add_iter` and the final exponentiation's
// cyclotomic square `cyc_sqr`.
//
// `miller_dbl_iter` / `miller_add_iter` replace the reference's Pallas
// kernels of those names (lighthouse_tpu/ops/lane/pairing.py:127-128,
// `_dbl_iter_body` / `_add_iter_body`): per lane, the G2 doubling (or mixed
// addition) step in Jacobian coordinates with the line coefficients
// (c0, c1, c4) evaluated at P, then f <- f12sqr(f) (doubling only) and the
// sparse line product f * (c0 + c1 v + c4 v w). `cyc_sqr` replaces the
// reference's Pallas kernel `cyc_sqr` (pairing.py:257, `_cyc_sqr_body`):
// the Granger-Scott squaring of a cyclotomic Fp12, nine Fp2 squarings of
// the slot pairs (c0, c3), (c1, c4), (c2, c5), then each output slot
// reduce_light(3 t +- 2 c_k).
//
// Bound on the H100: integer operations. A doubling iteration does 106 Fp
// products (31 in the step, 36 in f12sqr, 39 in the 034 product), some
// 770,000 int32 operations against 2,592 bytes in and out; `cyc_sqr` 18
// products (~130,000 operations against 2 x 1,728 bytes). `cyc_sqr` runs
// at a lane width of 1 (315 launches per final exponentiation), where one
// element is all the work there is; `miller_dbl_iter` at the BLS bucket's
// width (up to 1,024 lanes) and at 1-2 lanes in the final checks.
//
// `miller_dbl_iter` and `cyc_sqr` are cooperative (coop.cuh): a block of
// DBL_WARPS / CYC_WARPS warps per lane element, the element's rows in
// shared memory, each Fp product one warp's job, the independent products
// of a stage side by side. Their programs are traced from the plain bodies
// by ops/lane/coop.py, which writes them into the generated header
// coop_programs.h (kernels.build, in the build directory): the doubling
// iteration is 7 stages of
// 186 jobs (106 products, 80 reduce_light) on 128 rows, cyc_sqr 2 stages
// (18 products, then 12 reduce_light) on 42 rows. The grid is one block
// per lane element. `miller_add_iter` keeps one thread per lane element:
// f, the point and the line in the thread's local memory, every Fp product
// in the out-of-line `fp_mul`.
#include "coop.cuh"
#include "coop_programs.h"
#include "tower.cuh"

namespace {

using lh::F2;
using lh::F12;
using lh::W;
using lh::lin2;
using lh::lin3;

// `_add_step_body`
__device__ __noinline__ void add_step(const int* XT, const int* YT,
                                      const int* ZT, const int* xQ,
                                      const int* yQ, const int* xP,
                                      const int* yP, int* X3, int* Y3, int* Z3,
                                      int* c0, int* c1, int* c4) {
  int Zsq[F2], H[F2], M[F2], HH[F2], I[F2], J[F2], V[F2], t[F2], u[F2];
  lh::f2sqr(Zsq, ZT);
  lh::f2mul(u, xQ, Zsq);                       // U2
  lin2<F2>(H, 1, u, -1, XT);                   // H = U2 - XT
  lh::f2mul(t, yQ, ZT);
  lh::f2mul(u, t, Zsq);                        // S2
  lin2<F2>(M, 1, u, -1, YT);                   // M = S2 - YT
  lh::f2sqr(HH, H);
  lin2<F2>(I, 4, HH, 0, HH);                   // I = 4 HH
  lh::f2mul(J, H, I);
  lh::f2mul(V, XT, I);
  lin2<F2>(u, 1, M, 1, M);                     // rr = M + M
  lh::f2sqr(t, u);
  lin3<F2>(X3, 1, t, -1, J, -2, V);            // F2S(rr) - J - 2 V
  lh::f2_reduce_light(X3);
  lin2<F2>(t, 1, V, -1, X3);
  lh::f2mul(Y3, u, t);                         // F2M(rr, V - X3)
  lh::f2mul(t, YT, J);                         // YJ
  lin2<F2>(Y3, 1, Y3, -2, t);                  // ... - YJ - YJ
  lh::f2_reduce_light(Y3);
  lin2<F2>(t, 1, ZT, 1, H);
  lh::f2sqr(Z3, t);
  lin3<F2>(Z3, 1, Z3, -1, Zsq, -1, HH);        // F2S(ZT + H) - Zsq - HH
  lh::f2_reduce_light(Z3);
  lh::f2mul(I, H, ZT);                         // HZ (I is free now)
  lh::f2mul(t, I, yQ);
  lh::f2mul(u, M, xQ);
  lin2<F2>(c0, 1, t, -1, u);                   // F2M(HZ, yQ) - F2M(M, xQ)
  lh::f2_reduce_light(c0);
  lh::fp_mul(c1, M, xP);
  lh::fp_mul(c1 + W, M + W, xP);
  int nyP[W];
  lin2<W>(nyP, -1, yP, 0, yP);                 // -yP
  lh::fp_mul(c4, I, nyP);
  lh::fp_mul(c4 + W, I + W, nyP);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_miller_add_iter(const int* __restrict__ f_in, const int* __restrict__ xt,
                      const int* __restrict__ yt, const int* __restrict__ zt,
                      const int* __restrict__ xq, const int* __restrict__ yq,
                      const int* __restrict__ xp, const int* __restrict__ yp,
                      int* __restrict__ f_out, int* __restrict__ x3_out,
                      int* __restrict__ y3_out, int* __restrict__ z3_out, int K,
                      int S) {
  long k, s;
  if (!lh::lane_index(K, S, &k, &s)) return;
  int f[F12], XT[F2], YT[F2], ZT[F2], xQ[F2], yQ[F2], xP[W], yP[W];
  int X3[F2], Y3[F2], Z3[F2], c0[F2], c1[F2], c4[F2];
  lh::load_rows<12>(f, f_in, k, s, S);
  lh::load_rows<2>(XT, xt, k, s, S);
  lh::load_rows<2>(YT, yt, k, s, S);
  lh::load_rows<2>(ZT, zt, k, s, S);
  lh::load_rows<2>(xQ, xq, k, s, S);
  lh::load_rows<2>(yQ, yq, k, s, S);
  lh::load_rows<1>(xP, xp, k, s, S);
  lh::load_rows<1>(yP, yp, k, s, S);
  add_step(XT, YT, ZT, xQ, yQ, xP, yP, X3, Y3, Z3, c0, c1, c4);
  lh::f12mul_034(f, f, c0, c1, c4);
  lh::store_rows<12>(f_out, f, k, s, S);
  lh::store_rows<2>(x3_out, X3, k, s, S);
  lh::store_rows<2>(y3_out, Y3, k, s, S);
  lh::store_rows<2>(z3_out, Z3, k, s, S);
}

// ------------------------------------------------------------ cooperative

// warps per lane element, from ops/lane/coop.py PROGRAMS
constexpr int DBL_WARPS = lh::coop::MILLER_DBL_ITER_WARPS;
constexpr int CYC_WARPS = lh::coop::CYC_SQR_WARPS;

using lh::coop::at;
using lh::coop::block_elem;
using lh::coop::c_prog_cyc_sqr;
using lh::coop::c_prog_miller_dbl_iter;
using lh::coop::dyn_smem;

// the kernels load 20 / 12 input rows and store 18 / 12 output rows
static_assert(lh::coop::MILLER_DBL_ITER_INS == 20 && lh::coop::MILLER_DBL_ITER_OUTS == 18,
              "miller_dbl_iter: f, XT, YT, ZT, xP, yP -> f, X3, Y3, Z3");
static_assert(lh::coop::CYC_SQR_INS == 12 && lh::coop::CYC_SQR_OUTS == 12,
              "cyc_sqr: f -> f^2");

// the dynamic shared memory each block launches with
constexpr int DBL_SMEM = 4 * lh::coop::smem_ints(DBL_WARPS, lh::coop::MILLER_DBL_ITER_ROWS);
constexpr int CYC_SMEM = 4 * lh::coop::smem_ints(CYC_WARPS, lh::coop::CYC_SQR_ROWS);
static_assert(DBL_SMEM <= 227 * 1024 && CYC_SMEM <= 227 * 1024, "a block's shared memory");

__global__ void __launch_bounds__(DBL_WARPS * 32)
    k_miller_dbl_iter(const int* __restrict__ f_in, const int* __restrict__ xt,
                      const int* __restrict__ yt, const int* __restrict__ zt,
                      const int* __restrict__ xp, const int* __restrict__ yp,
                      int* __restrict__ f_out, int* __restrict__ x3_out,
                      int* __restrict__ y3_out, int* __restrict__ z3_out, int S) {
  constexpr int NW = DBL_WARPS;
  long k, s;
  block_elem(S, &k, &s);
  int* smem = dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  // the program's input rows: f (12), XT, YT, ZT (2 each), xP, yP
  lh::coop::load<NW>(rows, f_in, 12, k, s, S);
  lh::coop::load<NW>(rows + 12 * W, xt, 2, k, s, S);
  lh::coop::load<NW>(rows + 14 * W, yt, 2, k, s, S);
  lh::coop::load<NW>(rows + 16 * W, zt, 2, k, s, S);
  lh::coop::load<NW>(rows + 18 * W, xp, 1, k, s, S);
  lh::coop::load<NW>(rows + 19 * W, yp, 1, k, s, S);
  __syncthreads();
  lh::coop::run<NW>(c_prog_miller_dbl_iter, smem);
  // its outputs: f (12), X3, Y3, Z3 (2 each)
  for (int t = threadIdx.x; t < 18 * W; t += NW * 32) {
    const int o = t / W, i = t - o * W;
    const int v = lh::coop::out_limb(c_prog_miller_dbl_iter, smem, NW, o, i);
    if (o < 12) {
      f_out[at(12, o, i, k, s, S)] = v;
    } else {
      (o < 14 ? x3_out : (o < 16 ? y3_out : z3_out))[at(2, o % 2, i, k, s, S)] = v;
    }
  }
}

__global__ void __launch_bounds__(CYC_WARPS * 32)
    k_cyc_sqr(const int* __restrict__ a, int* __restrict__ out, int S) {
  constexpr int NW = CYC_WARPS;
  long k, s;
  block_elem(S, &k, &s);
  int* smem = dyn_smem();
  lh::coop::load<NW>(lh::coop::setup<NW>(smem), a, 12, k, s, S);
  __syncthreads();
  lh::coop::run<NW>(c_prog_cyc_sqr, smem);
  for (int t = threadIdx.x; t < 12 * W; t += NW * 32) {
    const int o = t / W, i = t - o * W;
    out[at(12, o, i, k, s, S)] = lh::coop::out_limb(c_prog_cyc_sqr, smem, NW, o, i);
  }
}

}  // namespace

LH_EXPORT int lh_miller_init(const void* folds, const void* topfm) {
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = lh::coop::copy_tables(folds, topfm);
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_miller_dbl_iter,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, DBL_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_cyc_sqr, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  CYC_SMEM);
  }
  return e;
}

// The dynamic shared memory (bytes) a block of program `slot` (coop.py
// PROGRAMS: miller_dbl_iter, cyc_sqr) launches with; -1 for another slot.
LH_EXPORT int lh_miller_launch_smem(int slot) {
  return slot == lh::coop::MILLER_DBL_ITER_SLOT
             ? DBL_SMEM
             : (slot == lh::coop::CYC_SQR_SLOT ? CYC_SMEM : -1);
}

LH_EXPORT const char* lh_miller_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_miller_dbl_iter(const void* f, const void* xt, const void* yt,
                                 const void* zt, const void* xp, const void* yp,
                                 void* f_out, void* x3, void* y3, void* z3,
                                 int K, int S, void* stream) {
  k_miller_dbl_iter<<<(unsigned)((long)K * S), DBL_WARPS * 32, DBL_SMEM,
                      (cudaStream_t)stream>>>(
      (const int*)f, (const int*)xt, (const int*)yt, (const int*)zt,
      (const int*)xp, (const int*)yp, (int*)f_out, (int*)x3, (int*)y3,
      (int*)z3, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_miller_add_iter(const void* f, const void* xt, const void* yt,
                                 const void* zt, const void* xq, const void* yq,
                                 const void* xp, const void* yp, void* f_out,
                                 void* x3, void* y3, void* z3, int K, int S,
                                 void* stream) {
  k_miller_add_iter<<<lh::blocks_for(K, S), lh::THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const int*)f, (const int*)xt, (const int*)yt, (const int*)zt,
      (const int*)xq, (const int*)yq, (const int*)xp, (const int*)yp,
      (int*)f_out, (int*)x3, (int*)y3, (int*)z3, K, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_cyc_sqr(const void* a, void* out, int K, int S, void* stream) {
  k_cyc_sqr<<<(unsigned)((long)K * S), CYC_WARPS * 32, CYC_SMEM,
              (cudaStream_t)stream>>>((const int*)a, (int*)out, S);
  return (int)cudaGetLastError();
}
