// K3, K14: `jac_dbl_f1` and `jac_dbl_f2`, Jacobian doubling (dbl-2009-l)
// over Fp (G1) and over Fp2 (G2).
//
// Replace the reference's Pallas kernels `jac_dbl_f1` and `jac_dbl_f2`
// (lighthouse_tpu/ops/lane/jacobian.py:163-164, `_dbl_f1_body` /
// `_dbl_f2_body` -> `_dbl_body`): 5 squarings, 2 products and 3 light
// reductions per point, in the field of the point.
//
// Bound on the H100: integer operations (over Fp 7 Fp products, ~50,000
// int32 operations per point against 864 bytes in and out; over Fp2 each
// square is 2 and each product 3 Fp products, 16 in all, against 1,728
// bytes).
//
// `jac_dbl_f1` keeps one thread per lane element over `lh::jac_dbl<Fp1>`
// (jac.cuh): the coordinates and temporaries in the thread's local memory,
// each product in the out-of-line fp_mul.
//
// `jac_dbl_f2` is cooperative (coop.cuh): a block of JAC_DBL_F2_WARPS
// warps per lane element, the point's rows in shared memory, each Fp
// product and reduce_light one warp's job. Its program is traced from
// `_dbl_f2_body` by ops/lane/coop.py into the generated header
// coop_programs.h: 7 stages of 28 jobs (16 products, 12 reduce_light) on
// 18 rows. The grid is one block per lane element.
#include "coop.cuh"
#include "coop_programs.h"
#include "jac.cuh"

namespace {

using lh::W;

__global__ void __launch_bounds__(lh::THREADS)
    k_jac_dbl_f1(const int* __restrict__ x, const int* __restrict__ y,
                 const int* __restrict__ z, int* __restrict__ ox,
                 int* __restrict__ oy, int* __restrict__ oz, int K, int S) {
  long k, s;
  if (!lh::lane_index(K, S, &k, &s)) return;
  int X[W], Y[W], Z[W], X3[W], Y3[W], Z3[W];
  lh::load_rows<1>(X, x, k, s, S);
  lh::load_rows<1>(Y, y, k, s, S);
  lh::load_rows<1>(Z, z, k, s, S);
  lh::jac_dbl<lh::Fp1>(X, Y, Z, X3, Y3, Z3);
  lh::store_rows<1>(ox, X3, k, s, S);
  lh::store_rows<1>(oy, Y3, k, s, S);
  lh::store_rows<1>(oz, Z3, k, s, S);
}

// ------------------------------------------------------------ cooperative

constexpr int NW = lh::coop::JAC_DBL_F2_WARPS;  // from ops/lane/coop.py PROGRAMS
static_assert(lh::coop::JAC_DBL_F2_INS == 6 && lh::coop::JAC_DBL_F2_OUTS == 6,
              "jac_dbl_f2: X, Y, Z -> X3, Y3, Z3");
// the dynamic shared memory each block launches with
constexpr int DBL_F2_SMEM = 4 * lh::coop::smem_ints(NW, lh::coop::JAC_DBL_F2_ROWS);

using lh::coop::c_prog_jac_dbl_f2;

__global__ void __launch_bounds__(NW * 32, lh::coop::min_blocks(NW))
    k_jac_dbl_f2(const int* __restrict__ x, const int* __restrict__ y,
                 const int* __restrict__ z, int* __restrict__ ox,
                 int* __restrict__ oy, int* __restrict__ oz, int S) {
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  // the program's input rows: X, Y, Z (2 each)
  lh::coop::load_point<NW, 2>(rows, x, y, z, k, s, S);
  __syncthreads();
  lh::coop::run<NW>(c_prog_jac_dbl_f2, smem);
  // its outputs: X3, Y3, Z3 (2 each)
  lh::coop::store_point<NW, 2>(c_prog_jac_dbl_f2, smem, 0, false, x, y, z, ox, oy, oz, k, s,
                               S);
}

}  // namespace

LH_EXPORT int lh_jac_dbl_init(const void* folds, const void* topfm) {
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = lh::coop::copy_tables(folds, topfm);
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_jac_dbl_f2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  DBL_F2_SMEM);
  }
  return e;
}

// The dynamic shared memory (bytes) a block of program `slot` (coop.py
// PROGRAMS: jac_dbl_f2) launches with; -1 for another slot.
LH_EXPORT int lh_jac_dbl_launch_smem(int slot) {
  return slot == lh::coop::JAC_DBL_F2_SLOT ? DBL_F2_SMEM : -1;
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
  k_jac_dbl_f2<<<(unsigned)((long)K * S), NW * 32, DBL_F2_SMEM,
                 (cudaStream_t)stream>>>((const int*)x, (const int*)y,
                                         (const int*)z, (int*)ox, (int*)oy,
                                         (int*)oz, S);
  return (int)cudaGetLastError();
}
