// K4, K15: `jac_add_f1` and `jac_add_f2`, branchless Jacobian addition
// (add-2007-bl) over Fp (G1) and over Fp2 (G2), with the structural-
// infinity selects inside the kernel.
//
// Replace the reference's Pallas kernels `jac_add_f1` and `jac_add_f2`
// (lighthouse_tpu/ops/lane/jacobian.py:165-166, `_add_f1_body` /
// `_add_f2_body` -> `_add_body`): 5 squarings, 11 products and 4 light
// reductions per point pair, then P1 = inf ? P2 : (P2 = inf ? P1 : sum),
// infinity meaning Z has every limb (of both components over Fp2) exactly 0.
//
// Bound on the H100: integer operations (over Fp 16 Fp products, ~116,000
// int32 operations per pair against 1,296 bytes in and out; over Fp2 43 Fp
// products against 2,592 bytes).
//
// Both are cooperative (coop.cuh), one kernel template `add` over the
// component count C (1 over Fp, 2 over Fp2): a block of JAC_ADD_F1_WARPS
// or JAC_ADD_F2_WARPS warps per lane element, both points' rows in shared
// memory, each Fp product, square and reduce_light one warp's job. The
// programs are traced from `_add_core_f1` and `_add_core_f2` (add-2007-bl
// without the selection) by ops/lane/coop.py into the generated header
// coop_programs.h, mapping (P1, P2) to the sum: over Fp 7 stages of 20
// jobs (16 products and squares, 4 reduce_light) on 14 rows, over Fp2 10
// stages of 73 jobs (43 products, 30 reduce_light) on 31 rows. The
// selects (`_add_select`) are uniform over the block, one lane element:
// the block tests Z1 and Z2 while their rows still hold the inputs
// (`__syncthreads_or`), runs the program, then writes P2 (P1 at infinity),
// P1 (P2 at infinity), each re-read from global memory, or the sum. G1's
// program replaces one thread per lane element that kept about a dozen
// field temporaries in local memory (jac.cuh, which the ladder steps
// still use).
#include "coop.cuh"
#include "coop_programs.h"

namespace {

using lh::W;

// warps per lane element, from ops/lane/coop.py PROGRAMS
constexpr int NW1 = lh::coop::JAC_ADD_F1_WARPS;
constexpr int NW2 = lh::coop::JAC_ADD_F2_WARPS;
static_assert(lh::coop::JAC_ADD_F1_INS == 6 && lh::coop::JAC_ADD_F1_OUTS == 3,
              "jac_add_f1: P1, P2 -> P1 + P2");
static_assert(lh::coop::JAC_ADD_F2_INS == 12 && lh::coop::JAC_ADD_F2_OUTS == 6,
              "jac_add_f2: P1, P2 -> P1 + P2");
// the dynamic shared memory each block launches with
constexpr int ADD_F1_SMEM = 4 * lh::coop::smem_ints(NW1, lh::coop::JAC_ADD_F1_ROWS);
constexpr int ADD_F2_SMEM = 4 * lh::coop::smem_ints(NW2, lh::coop::JAC_ADD_F2_ROWS);

// The add of lane element blockIdx.x through program `prog`, over points
// of C rows a coordinate.
template <int NW, int C>
__device__ __forceinline__ void add(const int* prog, const int* __restrict__ x1,
                                    const int* __restrict__ y1, const int* __restrict__ z1,
                                    const int* __restrict__ x2, const int* __restrict__ y2,
                                    const int* __restrict__ z2, int* __restrict__ ox,
                                    int* __restrict__ oy, int* __restrict__ oz, int S) {
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  // the program's input rows: P1 (X1, Y1, Z1, C each), then P2
  lh::coop::load_point<NW, C>(rows, x1, y1, z1, k, s, S);
  lh::coop::load_point<NW, C>(rows + 3 * C * W, x2, y2, z2, k, s, S);
  __syncthreads();
  // structural infinity of Z1 (rows 2C ..) and Z2 (rows 5C ..), before
  // the program may reuse them
  const bool p1_inf = lh::coop::rows_zero<NW>(rows + 2 * C * W, C);
  const bool p2_inf = lh::coop::rows_zero<NW>(rows + 5 * C * W, C);
  lh::coop::run<NW>(prog, smem);
  // `_add_select`: P1 at infinity -> P2; else P2 at infinity -> P1; else
  // the sum (outputs 0 .. 3C - 1)
  lh::coop::store_point<NW, C>(prog, smem, 0, p1_inf || p2_inf, p1_inf ? x2 : x1,
                               p1_inf ? y2 : y1, p1_inf ? z2 : z1, ox, oy, oz, k, s, S);
}

__global__ void __launch_bounds__(NW1 * 32, lh::coop::min_blocks(NW1))
    k_jac_add_f1(const int* __restrict__ x1, const int* __restrict__ y1,
                 const int* __restrict__ z1, const int* __restrict__ x2,
                 const int* __restrict__ y2, const int* __restrict__ z2,
                 int* __restrict__ ox, int* __restrict__ oy, int* __restrict__ oz, int S) {
  add<NW1, 1>(lh::coop::c_prog_jac_add_f1, x1, y1, z1, x2, y2, z2, ox, oy, oz, S);
}

__global__ void __launch_bounds__(NW2 * 32, lh::coop::min_blocks(NW2))
    k_jac_add_f2(const int* __restrict__ x1, const int* __restrict__ y1,
                 const int* __restrict__ z1, const int* __restrict__ x2,
                 const int* __restrict__ y2, const int* __restrict__ z2,
                 int* __restrict__ ox, int* __restrict__ oy, int* __restrict__ oz, int S) {
  add<NW2, 2>(lh::coop::c_prog_jac_add_f2, x1, y1, z1, x2, y2, z2, ox, oy, oz, S);
}

}  // namespace

LH_EXPORT int lh_jac_add_init(const void* folds, const void* topfm) {
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = lh::coop::copy_tables(folds, topfm);
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_jac_add_f1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  ADD_F1_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_jac_add_f2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  ADD_F2_SMEM);
  }
  return e;
}

// The dynamic shared memory (bytes) a block of program `slot` (coop.py
// PROGRAMS: jac_add_f1, jac_add_f2) launches with; -1 for another slot.
LH_EXPORT int lh_jac_add_launch_smem(int slot) {
  return slot == lh::coop::JAC_ADD_F1_SLOT
             ? ADD_F1_SMEM
             : (slot == lh::coop::JAC_ADD_F2_SLOT ? ADD_F2_SMEM : -1);
}

LH_EXPORT const char* lh_jac_add_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_jac_add_f1(const void* x1, const void* y1, const void* z1,
                            const void* x2, const void* y2, const void* z2,
                            void* ox, void* oy, void* oz, int K, int S,
                            void* stream) {
  k_jac_add_f1<<<(unsigned)((long)K * S), NW1 * 32, ADD_F1_SMEM,
                 (cudaStream_t)stream>>>(
      (const int*)x1, (const int*)y1, (const int*)z1, (const int*)x2,
      (const int*)y2, (const int*)z2, (int*)ox, (int*)oy, (int*)oz, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_jac_add_f2(const void* x1, const void* y1, const void* z1,
                            const void* x2, const void* y2, const void* z2,
                            void* ox, void* oy, void* oz, int K, int S,
                            void* stream) {
  k_jac_add_f2<<<(unsigned)((long)K * S), NW2 * 32, ADD_F2_SMEM,
                 (cudaStream_t)stream>>>(
      (const int*)x1, (const int*)y1, (const int*)z1, (const int*)x2,
      (const int*)y2, (const int*)z2, (int*)ox, (int*)oy, (int*)oz, S);
  return (int)cudaGetLastError();
}
