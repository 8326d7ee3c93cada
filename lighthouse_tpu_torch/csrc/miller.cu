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
// 770,000 int32 operations against 5,472 bytes in and out; an addition
// iteration 81 (42 in the step, 39 in the 034 product) against 6,048
// bytes; `cyc_sqr` 18 products (~130,000 operations against 2 x 1,728
// bytes). `cyc_sqr` runs at a lane width of 1 (315 launches per final
// exponentiation), where one element is all the work there is;
// `miller_dbl_iter` and `miller_add_iter` at the BLS bucket's width (up to
// 1,024 lanes) and at 1-2 lanes in the final checks.
//
// All three are cooperative (coop.cuh): a block of DBL_WARPS / ADD_WARPS /
// CYC_WARPS warps per lane element, the element's rows in shared memory,
// each Fp product one warp's job, the independent products of a stage side
// by side. Their programs are traced from the plain bodies by
// ops/lane/coop.py, which writes them into the generated header
// coop_programs.h (kernels.build, in the build directory): the doubling
// iteration is 7 stages of 186 jobs (106 products, 80 reduce_light) on 128
// rows, the addition iteration 10 stages of 135 jobs (81 products, 54
// reduce_light) on 69 rows, cyc_sqr 2 stages (18 products, then 12
// reduce_light) on 42 rows. The grid is one block per lane element. No
// program holds a select, so no kernel needs an epilogue.
#include "coop.cuh"
#include "coop_programs.h"

namespace {

using lh::W;

// warps per lane element, from ops/lane/coop.py PROGRAMS
constexpr int DBL_WARPS = lh::coop::MILLER_DBL_ITER_WARPS;
constexpr int ADD_WARPS = lh::coop::MILLER_ADD_ITER_WARPS;
constexpr int CYC_WARPS = lh::coop::CYC_SQR_WARPS;

using lh::coop::at;
using lh::coop::block_elem;
using lh::coop::c_prog_cyc_sqr;
using lh::coop::c_prog_miller_add_iter;
using lh::coop::c_prog_miller_dbl_iter;
using lh::coop::dyn_smem;

// the kernels load 20 / 24 / 12 input rows and store 18 / 18 / 12 output rows
static_assert(lh::coop::MILLER_DBL_ITER_INS == 20 && lh::coop::MILLER_DBL_ITER_OUTS == 18,
              "miller_dbl_iter: f, XT, YT, ZT, xP, yP -> f, X3, Y3, Z3");
static_assert(lh::coop::MILLER_ADD_ITER_INS == 24 && lh::coop::MILLER_ADD_ITER_OUTS == 18,
              "miller_add_iter: f, XT, YT, ZT, xQ, yQ, xP, yP -> f, X3, Y3, Z3");
static_assert(lh::coop::CYC_SQR_INS == 12 && lh::coop::CYC_SQR_OUTS == 12,
              "cyc_sqr: f -> f^2");

// the dynamic shared memory each block launches with
constexpr int DBL_SMEM = 4 * lh::coop::smem_ints(DBL_WARPS, lh::coop::MILLER_DBL_ITER_ROWS);
constexpr int ADD_SMEM = 4 * lh::coop::smem_ints(ADD_WARPS, lh::coop::MILLER_ADD_ITER_ROWS);
constexpr int CYC_SMEM = 4 * lh::coop::smem_ints(CYC_WARPS, lh::coop::CYC_SQR_ROWS);
static_assert(DBL_SMEM <= 227 * 1024 && ADD_SMEM <= 227 * 1024 && CYC_SMEM <= 227 * 1024,
              "a block's shared memory");

// f (12 rows), X3, Y3, Z3 (2 each): the iterations' 18 outputs
__device__ __forceinline__ void store_iter(const int* prog, const int* smem, int nw,
                                           int* __restrict__ f_out, int* __restrict__ x3_out,
                                           int* __restrict__ y3_out, int* __restrict__ z3_out,
                                           long k, long s, int S) {
  for (int t = threadIdx.x; t < 18 * W; t += nw * 32) {
    const int o = t / W, i = t - o * W;
    const int v = lh::coop::out_limb(prog, smem, nw, o, i);
    if (o < 12) {
      f_out[at(12, o, i, k, s, S)] = v;
    } else {
      (o < 14 ? x3_out : (o < 16 ? y3_out : z3_out))[at(2, o % 2, i, k, s, S)] = v;
    }
  }
}

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
  store_iter(c_prog_miller_dbl_iter, smem, NW, f_out, x3_out, y3_out, z3_out, k, s, S);
}

// xQ, yQ: the same tensors in every addition of a Miller loop, only read
__global__ void __launch_bounds__(ADD_WARPS * 32)
    k_miller_add_iter(const int* __restrict__ f_in, const int* __restrict__ xt,
                      const int* __restrict__ yt, const int* __restrict__ zt,
                      const int* __restrict__ xq, const int* __restrict__ yq,
                      const int* __restrict__ xp, const int* __restrict__ yp,
                      int* __restrict__ f_out, int* __restrict__ x3_out,
                      int* __restrict__ y3_out, int* __restrict__ z3_out, int S) {
  constexpr int NW = ADD_WARPS;
  long k, s;
  block_elem(S, &k, &s);
  int* smem = dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  // the program's input rows: f (12), XT, YT, ZT, xQ, yQ (2 each), xP, yP
  lh::coop::load<NW>(rows, f_in, 12, k, s, S);
  lh::coop::load<NW>(rows + 12 * W, xt, 2, k, s, S);
  lh::coop::load<NW>(rows + 14 * W, yt, 2, k, s, S);
  lh::coop::load<NW>(rows + 16 * W, zt, 2, k, s, S);
  lh::coop::load<NW>(rows + 18 * W, xq, 2, k, s, S);
  lh::coop::load<NW>(rows + 20 * W, yq, 2, k, s, S);
  lh::coop::load<NW>(rows + 22 * W, xp, 1, k, s, S);
  lh::coop::load<NW>(rows + 23 * W, yp, 1, k, s, S);
  __syncthreads();
  lh::coop::run<NW>(c_prog_miller_add_iter, smem);
  store_iter(c_prog_miller_add_iter, smem, NW, f_out, x3_out, y3_out, z3_out, k, s, S);
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
    e = (int)cudaFuncSetAttribute(k_miller_add_iter,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, ADD_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_cyc_sqr, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  CYC_SMEM);
  }
  return e;
}

// The dynamic shared memory (bytes) a block of program `slot` (coop.py
// PROGRAMS: miller_dbl_iter, miller_add_iter, cyc_sqr) launches with; -1
// for another slot.
LH_EXPORT int lh_miller_launch_smem(int slot) {
  if (slot == lh::coop::MILLER_DBL_ITER_SLOT) return DBL_SMEM;
  if (slot == lh::coop::MILLER_ADD_ITER_SLOT) return ADD_SMEM;
  return slot == lh::coop::CYC_SQR_SLOT ? CYC_SMEM : -1;
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
  k_miller_add_iter<<<(unsigned)((long)K * S), ADD_WARPS * 32, ADD_SMEM,
                      (cudaStream_t)stream>>>(
      (const int*)f, (const int*)xt, (const int*)yt, (const int*)zt,
      (const int*)xq, (const int*)yq, (const int*)xp, (const int*)yp,
      (int*)f_out, (int*)x3, (int*)y3, (int*)z3, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_cyc_sqr(const void* a, void* out, int K, int S, void* stream) {
  k_cyc_sqr<<<(unsigned)((long)K * S), CYC_WARPS * 32, CYC_SMEM,
              (cudaStream_t)stream>>>((const int*)a, (int*)out, S);
  return (int)cudaGetLastError();
}
