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
// Both are cooperative (coop.cuh), one kernel template `dbl` over the
// component count C (1 over Fp, 2 over Fp2): a block of JAC_DBL_F1_WARPS
// or JAC_DBL_F2_WARPS warps per lane element, the point's rows in shared
// memory, each Fp product, square and reduce_light one warp's job. The
// programs are traced from `_dbl_f1_body` and `_dbl_f2_body` by
// ops/lane/coop.py into the generated header coop_programs.h: over Fp 6
// stages of 11 jobs (7 products and squares, 4 reduce_light) on 8 rows,
// over Fp2 7 stages of 28 jobs (16 products, 12 reduce_light) on 18 rows.
// The grid is one block per lane element. G1's program replaces one
// thread per lane element that kept the coordinates and temporaries in
// local memory. The ladder steps (ladder.cu) run both programs too.
#include "coop.cuh"
#include "coop_programs.h"

namespace {

using lh::W;

// warps per lane element, from ops/lane/coop.py PROGRAMS
constexpr int NW1 = lh::coop::JAC_DBL_F1_WARPS;
constexpr int NW2 = lh::coop::JAC_DBL_F2_WARPS;
static_assert(lh::coop::JAC_DBL_F1_INS == 3 && lh::coop::JAC_DBL_F1_OUTS == 3,
              "jac_dbl_f1: X, Y, Z -> X3, Y3, Z3");
static_assert(lh::coop::JAC_DBL_F2_INS == 6 && lh::coop::JAC_DBL_F2_OUTS == 6,
              "jac_dbl_f2: X, Y, Z -> X3, Y3, Z3");
// the dynamic shared memory each block launches with
constexpr int DBL_F1_SMEM = 4 * lh::coop::smem_ints(NW1, lh::coop::JAC_DBL_F1_ROWS);
constexpr int DBL_F2_SMEM = 4 * lh::coop::smem_ints(NW2, lh::coop::JAC_DBL_F2_ROWS);

// The doubling of lane element blockIdx.x through program `prog`, over
// points of C rows a coordinate.
template <int NW, int C>
__device__ __forceinline__ void dbl(const int* prog, const int* __restrict__ x,
                                    const int* __restrict__ y, const int* __restrict__ z,
                                    int* __restrict__ ox, int* __restrict__ oy,
                                    int* __restrict__ oz, int S) {
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  // the program's input rows: X, Y, Z (C each)
  lh::coop::load_point<NW, C>(rows, x, y, z, k, s, S);
  __syncthreads();
  lh::coop::run<NW>(prog, smem);
  // its outputs: X3, Y3, Z3 (C each)
  lh::coop::store_point<NW, C>(prog, smem, 0, false, x, y, z, ox, oy, oz, k, s, S);
}

__global__ void __launch_bounds__(NW1 * 32, lh::coop::min_blocks(NW1))
    k_jac_dbl_f1(const int* __restrict__ x, const int* __restrict__ y,
                 const int* __restrict__ z, int* __restrict__ ox, int* __restrict__ oy,
                 int* __restrict__ oz, int S) {
  dbl<NW1, 1>(lh::coop::c_prog_jac_dbl_f1, x, y, z, ox, oy, oz, S);
}

__global__ void __launch_bounds__(NW2 * 32, lh::coop::min_blocks(NW2))
    k_jac_dbl_f2(const int* __restrict__ x, const int* __restrict__ y,
                 const int* __restrict__ z, int* __restrict__ ox, int* __restrict__ oy,
                 int* __restrict__ oz, int S) {
  dbl<NW2, 2>(lh::coop::c_prog_jac_dbl_f2, x, y, z, ox, oy, oz, S);
}

}  // namespace

LH_EXPORT int lh_jac_dbl_init(const void* folds, const void* topfm) {
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = lh::coop::copy_tables(folds, topfm);
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_jac_dbl_f1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  DBL_F1_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_jac_dbl_f2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  DBL_F2_SMEM);
  }
  return e;
}

// The dynamic shared memory (bytes) a block of program `slot` (coop.py
// PROGRAMS: jac_dbl_f1, jac_dbl_f2) launches with; -1 for another slot.
LH_EXPORT int lh_jac_dbl_launch_smem(int slot) {
  return slot == lh::coop::JAC_DBL_F1_SLOT
             ? DBL_F1_SMEM
             : (slot == lh::coop::JAC_DBL_F2_SLOT ? DBL_F2_SMEM : -1);
}

LH_EXPORT const char* lh_jac_dbl_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_jac_dbl_f1(const void* x, const void* y, const void* z,
                            void* ox, void* oy, void* oz, int K, int S,
                            void* stream) {
  k_jac_dbl_f1<<<(unsigned)((long)K * S), NW1 * 32, DBL_F1_SMEM,
                 (cudaStream_t)stream>>>((const int*)x, (const int*)y,
                                         (const int*)z, (int*)ox, (int*)oy,
                                         (int*)oz, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_jac_dbl_f2(const void* x, const void* y, const void* z,
                            void* ox, void* oy, void* oz, int K, int S,
                            void* stream) {
  k_jac_dbl_f2<<<(unsigned)((long)K * S), NW2 * 32, DBL_F2_SMEM,
                 (cudaStream_t)stream>>>((const int*)x, (const int*)y,
                                         (const int*)z, (int*)ox, (int*)oy,
                                         (int*)oz, S);
  return (int)cudaGetLastError();
}
