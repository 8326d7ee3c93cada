// K16, K17: `ladder_step_f1` and `ladder_step_f2`, one step of the per-lane
// dynamic scalar ladder (ops/lane/jacobian.py `scalar_mul`,
// `scalar_mul_with_static`) over G1 and over G2.
//
// Replace the reference's Pallas kernels `ladder_step_f1` and
// `ladder_step_f2` (lighthouse_tpu/ops/lane/jacobian.py:167-168,
// `_ladder_step_body`): the branchless add of the addend into the
// accumulator (add-2007-bl and `_add_select`'s structural-infinity cases),
// kept on the lane elements whose bit is set, and the doubling of the
// addend (dbl-2009-l). Six coordinates in (accumulator, addend) plus the
// bit row, six out (accumulator, doubled addend).
//
// Bound on the H100: integer operations. The doubling runs on every lane
// element (over Fp 7 Fp products, ~50,000 int32 operations; over Fp2 16),
// the add only where the bit is set (16 Fp products, ~116,000 operations;
// over Fp2 43), against 12 Fp elements and a bit in and 6 out (~2.6 KB;
// over Fp2 ~5.2 KB).
//
// Both are cooperative (coop.cuh), one kernel template `step` over the
// component count C (1 over Fp, 2 over Fp2): a block of
// LADDER_STEP_F1_WARPS or LADDER_STEP_F2_WARPS warps per lane element runs
// two programs that jac_add.cu and jac_dbl.cu run too, the add's
// (`_add_core_f1` / `_add_core_f2`: 7 stages of 20 jobs on 14 rows, 10
// stages of 73 jobs on 31 rows) and the doubling's (`_dbl_f1_body` /
// `_dbl_f2_body`: 6 stages of 11 jobs on 8 rows, 7 stages of 28 jobs on 18
// rows), so the ladder adds no word to the constant bank (coop.py
// LADDERS). The block copies the tables once and holds the rows of the
// larger program, the add's. The bit is one int32 per lane element ([K, 1,
// S]); one block is one lane element, so the bit is uniform over the
// block, as the window step's digit. Where it is set, the block loads the
// accumulator and the addend, tests Z1 and Z2 while their rows still hold
// the inputs (`__syncthreads_or`), runs the add's program and writes
// `_add_select`'s pick: P2 where P1 is at infinity, P1 where P2 is (each
// re-read from global memory), else the sum. Where it is clear, the block
// skips the add and copies the accumulator, which the plain body computes
// the add for and discards. Then it loads the addend into the doubling's
// input rows and runs the doubling's program. This replaces one thread
// per lane element that ran both bodies with their temporaries in local
// memory.
#include "coop.cuh"
#include "coop_programs.h"

namespace {

using lh::W;

// warps per lane element, from ops/lane/coop.py LADDERS
constexpr int NW1 = lh::coop::LADDER_STEP_F1_WARPS;
constexpr int NW2 = lh::coop::LADDER_STEP_F2_WARPS;
static_assert(lh::coop::JAC_ADD_F1_INS == 6 && lh::coop::JAC_ADD_F1_OUTS == 3 &&
                  lh::coop::JAC_ADD_F2_INS == 12 && lh::coop::JAC_ADD_F2_OUTS == 6,
              "jac_add_fN: P1, P2 -> P1 + P2");
static_assert(lh::coop::JAC_DBL_F1_INS == 3 && lh::coop::JAC_DBL_F1_OUTS == 3 &&
                  lh::coop::JAC_DBL_F2_INS == 6 && lh::coop::JAC_DBL_F2_OUTS == 6,
              "jac_dbl_fN: X, Y, Z -> X3, Y3, Z3");
static_assert(lh::coop::JAC_ADD_F1_ROWS >= lh::coop::JAC_DBL_F1_ROWS &&
                  lh::coop::JAC_ADD_F2_ROWS >= lh::coop::JAC_DBL_F2_ROWS,
              "the add's rows hold the doubling's");
// the dynamic shared memory each block launches with: the add's rows
constexpr int STEP_F1_SMEM = 4 * lh::coop::smem_ints(NW1, lh::coop::JAC_ADD_F1_ROWS);
constexpr int STEP_F2_SMEM = 4 * lh::coop::smem_ints(NW2, lh::coop::JAC_ADD_F2_ROWS);

// the 6 coordinate operands and the 6 outputs travel by value in one struct
struct Coords {
  const int* in[6];  // X1, Y1, Z1 (accumulator), Xa, Ya, Za (addend)
  int* out[6];       // X, Y, Z (accumulator), Xd, Yd, Zd (doubled addend)
};

// One ladder step of lane element blockIdx.x through the add's program
// `add_prog` and the doubling's `dbl_prog`, over points of C rows a
// coordinate.
template <int NW, int C>
__device__ __forceinline__ void step(const int* add_prog, const int* dbl_prog, const Coords& c,
                                     const int* __restrict__ bit, int S) {
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  if (bit[k * S + s] != 0) {
    // the add's input rows: P1 = the accumulator, then P2 = the addend
    lh::coop::load_point<NW, C>(rows, c.in[0], c.in[1], c.in[2], k, s, S);
    lh::coop::load_point<NW, C>(rows + 3 * C * W, c.in[3], c.in[4], c.in[5], k, s, S);
    __syncthreads();
    // structural infinity of Z1 (rows 2C ..) and Z2 (rows 5C ..), before
    // the program may reuse them
    const bool p1_inf = lh::coop::rows_zero<NW>(rows + 2 * C * W, C);
    const bool p2_inf = lh::coop::rows_zero<NW>(rows + 5 * C * W, C);
    lh::coop::run<NW>(add_prog, smem);
    // `_add_select`: P1 at infinity -> P2; else P2 at infinity -> P1; else
    // the sum (outputs 0 .. 3C - 1)
    lh::coop::store_point<NW, C>(add_prog, smem, 0, p1_inf || p2_inf,
                                 p1_inf ? c.in[3] : c.in[0], p1_inf ? c.in[4] : c.in[1],
                                 p1_inf ? c.in[5] : c.in[2], c.out[0], c.out[1], c.out[2], k,
                                 s, S);
    __syncthreads();  // the sum is read before the doubling's rows replace it
  } else {
    // the accumulator, re-read from global memory
    lh::coop::store_point<NW, C>(add_prog, smem, 0, true, c.in[0], c.in[1], c.in[2], c.out[0],
                                 c.out[1], c.out[2], k, s, S);
  }
  // the doubling's input rows: the addend
  lh::coop::load_point<NW, C>(rows, c.in[3], c.in[4], c.in[5], k, s, S);
  __syncthreads();
  lh::coop::run<NW>(dbl_prog, smem);
  lh::coop::store_point<NW, C>(dbl_prog, smem, 0, false, c.in[3], c.in[4], c.in[5], c.out[3],
                               c.out[4], c.out[5], k, s, S);
}

__global__ void __launch_bounds__(NW1 * 32, lh::coop::min_blocks(NW1))
    k_ladder_step_f1(Coords c, const int* __restrict__ bit, int S) {
  step<NW1, 1>(lh::coop::c_prog_jac_add_f1, lh::coop::c_prog_jac_dbl_f1, c, bit, S);
}

__global__ void __launch_bounds__(NW2 * 32, lh::coop::min_blocks(NW2))
    k_ladder_step_f2(Coords c, const int* __restrict__ bit, int S) {
  step<NW2, 2>(lh::coop::c_prog_jac_add_f2, lh::coop::c_prog_jac_dbl_f2, c, bit, S);
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
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = lh::coop::copy_tables(folds, topfm);
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_ladder_step_f1,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, STEP_F1_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_ladder_step_f2,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, STEP_F2_SMEM);
  }
  return e;
}

// The dynamic shared memory (bytes) a block of `ladder_step_f1` or
// `ladder_step_f2` launches with, asked by the slot of its first program
// (coop.py LADDERS: jac_add_f1, jac_add_f2); -1 for another slot.
LH_EXPORT int lh_ladder_launch_smem(int slot) {
  return slot == lh::coop::JAC_ADD_F1_SLOT
             ? STEP_F1_SMEM
             : (slot == lh::coop::JAC_ADD_F2_SLOT ? STEP_F2_SMEM : -1);
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
  k_ladder_step_f1<<<(unsigned)((long)K * S), NW1 * 32, STEP_F1_SMEM,
                     (cudaStream_t)stream>>>(coords(in, out), (const int*)bit, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_ladder_step_f2(LH_STEP_ARGS) {
  const void* in[6] = {x1, y1, z1, xa, ya, za};
  void* out[6] = {ox, oy, oz, oxd, oyd, ozd};
  k_ladder_step_f2<<<(unsigned)((long)K * S), NW2 * 32, STEP_F2_SMEM,
                     (cudaStream_t)stream>>>(coords(in, out), (const int*)bit, S);
  return (int)cudaGetLastError();
}
