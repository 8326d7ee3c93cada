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
// `jac_add_f1` (the MSM's) keeps one thread per lane element over
// `lh::jac_add<Fp1>` (jac.cuh): about a dozen field temporaries in the
// thread's local memory, the body out of line, each product in the
// out-of-line fp_mul with its limbs in registers.
//
// `jac_add_f2` is cooperative (coop.cuh): a block of JAC_ADD_F2_WARPS warps
// per lane element, both points' rows in shared memory, each Fp product,
// square and reduce_light one warp's job. Its program is traced from
// `_add_core_f2` (add-2007-bl without the selection) by ops/lane/coop.py
// into the generated header coop_programs.h: 10 stages of 73 jobs (43
// products, 30 reduce_light) on 31 rows, mapping (P1, P2) to the sum. The
// selects (`_add_select`) are uniform over the block, one lane element:
// the block tests Z1 and Z2 while their rows still hold the inputs
// (`__syncthreads_or`), runs the program, then writes P2 (P1 at infinity),
// P1 (P2 at infinity), each re-read from global memory, or the sum.
#include "coop.cuh"
#include "coop_programs.h"
#include "jac.cuh"

namespace {

using lh::W;

__global__ void __launch_bounds__(lh::THREADS)
    k_jac_add_f1(const int* __restrict__ x1, const int* __restrict__ y1,
                 const int* __restrict__ z1, const int* __restrict__ x2,
                 const int* __restrict__ y2, const int* __restrict__ z2,
                 int* __restrict__ ox, int* __restrict__ oy,
                 int* __restrict__ oz, int K, int S) {
  long k, s;
  if (!lh::lane_index(K, S, &k, &s)) return;
  int X1[W], Y1[W], Z1[W], X2[W], Y2[W], Z2[W], X3[W], Y3[W], Z3[W];
  lh::load_rows<1>(X1, x1, k, s, S);
  lh::load_rows<1>(Y1, y1, k, s, S);
  lh::load_rows<1>(Z1, z1, k, s, S);
  lh::load_rows<1>(X2, x2, k, s, S);
  lh::load_rows<1>(Y2, y2, k, s, S);
  lh::load_rows<1>(Z2, z2, k, s, S);
  lh::jac_add<lh::Fp1>(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3);
  lh::store_rows<1>(ox, X3, k, s, S);
  lh::store_rows<1>(oy, Y3, k, s, S);
  lh::store_rows<1>(oz, Z3, k, s, S);
}

// ------------------------------------------------------------ cooperative

constexpr int NW = lh::coop::JAC_ADD_F2_WARPS;  // from ops/lane/coop.py PROGRAMS
static_assert(lh::coop::JAC_ADD_F2_INS == 12 && lh::coop::JAC_ADD_F2_OUTS == 6,
              "jac_add_f2: P1, P2 -> P1 + P2");
// the dynamic shared memory each block launches with
constexpr int ADD_F2_SMEM = 4 * lh::coop::smem_ints(NW, lh::coop::JAC_ADD_F2_ROWS);

__global__ void __launch_bounds__(NW * 32, lh::coop::min_blocks(NW))
    k_jac_add_f2(const int* __restrict__ x1, const int* __restrict__ y1,
                 const int* __restrict__ z1, const int* __restrict__ x2,
                 const int* __restrict__ y2, const int* __restrict__ z2,
                 int* __restrict__ ox, int* __restrict__ oy, int* __restrict__ oz, int S) {
  const int* prog = lh::coop::c_prog_jac_add_f2;
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  // the program's input rows: P1 (X1, Y1, Z1, 2 each), then P2
  lh::coop::load_point<NW, 2>(rows, x1, y1, z1, k, s, S);
  lh::coop::load_point<NW, 2>(rows + 6 * W, x2, y2, z2, k, s, S);
  __syncthreads();
  // structural infinity of Z1 (rows 4-5) and Z2 (rows 10-11), before the
  // program may reuse them
  const bool p1_inf = lh::coop::rows_zero<NW>(rows + 4 * W, 2);
  const bool p2_inf = lh::coop::rows_zero<NW>(rows + 10 * W, 2);
  lh::coop::run<NW>(prog, smem);
  // `_add_select`: P1 at infinity -> P2; else P2 at infinity -> P1; else
  // the sum (outputs 0-5)
  lh::coop::store_point<NW, 2>(prog, smem, 0, p1_inf || p2_inf, p1_inf ? x2 : x1,
                               p1_inf ? y2 : y1, p1_inf ? z2 : z1, ox, oy, oz, k, s, S);
}

}  // namespace

LH_EXPORT int lh_jac_add_init(const void* folds, const void* topfm) {
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = lh::coop::copy_tables(folds, topfm);
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_jac_add_f2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  ADD_F2_SMEM);
  }
  return e;
}

// The dynamic shared memory (bytes) a block of program `slot` (coop.py
// PROGRAMS: jac_add_f2) launches with; -1 for another slot.
LH_EXPORT int lh_jac_add_launch_smem(int slot) {
  return slot == lh::coop::JAC_ADD_F2_SLOT ? ADD_F2_SMEM : -1;
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

LH_EXPORT int lh_jac_add_f2(const void* x1, const void* y1, const void* z1,
                            const void* x2, const void* y2, const void* z2,
                            void* ox, void* oy, void* oz, int K, int S,
                            void* stream) {
  k_jac_add_f2<<<(unsigned)((long)K * S), NW * 32, ADD_F2_SMEM,
                 (cudaStream_t)stream>>>(
      (const int*)x1, (const int*)y1, (const int*)z1, (const int*)x2,
      (const int*)y2, (const int*)z2, (int*)ox, (int*)oy, (int*)oz, S);
  return (int)cudaGetLastError();
}
