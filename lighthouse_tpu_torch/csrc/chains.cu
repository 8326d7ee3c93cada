// K18, K19: `g1_win_step` and `g2_win_step`, one window of the 2-bit
// windowed scalar ladder (ops/lane/chains.py `scalar_mul_w2`) over G1 and
// over G2: acc <- [4]acc + T[digit].
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
// products against ~11 KB). The digit is one int32 per lane ([K, 1, S]),
// not a field element.
//
// Both are cooperative (coop.cuh), one kernel template `win_step` over the
// component count C (1 over Fp, 2 over Fp2): a block of G1_WIN_STEP_WARPS
// or G2_WIN_STEP_WARPS warps per lane element, its rows in shared memory,
// each Fp product and reduce_light one warp's job. The programs, traced by
// ops/lane/coop.py from `_win_core_f1` (18 stages of 42 jobs, 30 of them
// products, on 20 rows) and `_win_core_f2` (23 stages of 129 jobs, 75
// products, on 53 rows), map (acc, E) to ([4]acc, [4]acc + E): the two
// doublings and add-2007-bl without its selection. The selects of the
// plain body are uniform over the block, one lane element, so they only
// choose rows: the block reads its digit and loads T[digit] as E, tests
// E's Z before the program and [4]acc's Z after it (`__syncthreads_or`),
// then writes [4]acc, E or the sum in the body's order of precedence
// (`_win_select`). G1's program replaces one thread per lane element that
// kept the accumulator, the table and the temporaries in local memory.
#include "coop.cuh"
#include "coop_programs.h"

namespace {

using lh::W;

// the 12 coordinate operands travel by value in one struct
struct Coords {
  const int* p[12];
};

// warps per lane element, from ops/lane/coop.py PROGRAMS
constexpr int NW1 = lh::coop::G1_WIN_STEP_WARPS;
constexpr int NW2 = lh::coop::G2_WIN_STEP_WARPS;
static_assert(lh::coop::G1_WIN_STEP_INS == 6 && lh::coop::G1_WIN_STEP_OUTS == 6,
              "g1_win_step: acc, E -> [4]acc, [4]acc + E");
static_assert(lh::coop::G2_WIN_STEP_INS == 12 && lh::coop::G2_WIN_STEP_OUTS == 12,
              "g2_win_step: acc, E -> [4]acc, [4]acc + E");
// the dynamic shared memory each block launches with
constexpr int WIN1_SMEM = 4 * lh::coop::smem_ints(NW1, lh::coop::G1_WIN_STEP_ROWS);
constexpr int WIN2_SMEM = 4 * lh::coop::smem_ints(NW2, lh::coop::G2_WIN_STEP_ROWS);

// Coordinate c of the table entry of digit d: T3 for 3, T2 for 2, T1 for
// 0 and 1 (constant indices: a dynamic index into the parameter struct
// would copy it to the stack).
__device__ __forceinline__ const int* entry(const Coords& in, int d, int c) {
  return d == 3 ? in.p[9 + c] : (d == 2 ? in.p[6 + c] : in.p[3 + c]);
}

// One window step of lane element blockIdx.x through program `prog`, over
// points of C rows a coordinate.
template <int NW, int C>
__device__ __forceinline__ void win_step(const int* prog, const Coords& in,
                                         const int* __restrict__ dig, int* __restrict__ ox,
                                         int* __restrict__ oy, int* __restrict__ oz, int S) {
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  const int d = dig[k * S + s];
  const int *ex = entry(in, d, 0), *ey = entry(in, d, 1), *ez = entry(in, d, 2);
  // the program's input rows: acc, then E = T[d]
  lh::coop::load_point<NW, C>(rows, in.p[0], in.p[1], in.p[2], k, s, S);
  lh::coop::load_point<NW, C>(rows + 3 * C * W, ex, ey, ez, k, s, S);
  __syncthreads();
  // structural infinity of E's Z (rows 5C ..) before the program may
  // reuse them, and of [4]acc's Z (outputs 2C ..) after it
  const bool p2_inf = lh::coop::rows_zero<NW>(rows + 5 * C * W, C);
  lh::coop::run<NW>(prog, smem);
  const bool p1_inf = lh::coop::outs_zero<NW>(prog, smem, 2 * C, C);
  // `_win_select`: digit 0 -> [4]acc; else P1 = [4]acc at infinity -> E;
  // else E at infinity -> [4]acc; else the sum (outputs 3C ..)
  const bool pick_e = d != 0 && p1_inf;
  const int first = (d == 0 || p2_inf) ? 0 : 3 * C;
  lh::coop::store_point<NW, C>(prog, smem, first, pick_e, ex, ey, ez, ox, oy, oz, k, s, S);
}

__global__ void __launch_bounds__(NW1 * 32, lh::coop::min_blocks(NW1))
    k_g1_win_step(Coords in, const int* __restrict__ dig, int* __restrict__ ox,
                  int* __restrict__ oy, int* __restrict__ oz, int S) {
  win_step<NW1, 1>(lh::coop::c_prog_g1_win_step, in, dig, ox, oy, oz, S);
}

__global__ void __launch_bounds__(NW2 * 32, lh::coop::min_blocks(NW2))
    k_g2_win_step(Coords in, const int* __restrict__ dig, int* __restrict__ ox,
                  int* __restrict__ oy, int* __restrict__ oz, int S) {
  win_step<NW2, 2>(lh::coop::c_prog_g2_win_step, in, dig, ox, oy, oz, S);
}

Coords coords(const void* const* a) {
  Coords c;
  for (int i = 0; i < 12; ++i) c.p[i] = (const int*)a[i];
  return c;
}

}  // namespace

LH_EXPORT int lh_chains_init(const void* folds, const void* topfm) {
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = lh::coop::copy_tables(folds, topfm);
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_g1_win_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  WIN1_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_g2_win_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  WIN2_SMEM);
  }
  return e;
}

// The dynamic shared memory (bytes) a block of program `slot` (coop.py
// PROGRAMS: g1_win_step, g2_win_step) launches with; -1 for another slot.
LH_EXPORT int lh_chains_launch_smem(int slot) {
  return slot == lh::coop::G1_WIN_STEP_SLOT
             ? WIN1_SMEM
             : (slot == lh::coop::G2_WIN_STEP_SLOT ? WIN2_SMEM : -1);
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
  k_g1_win_step<<<(unsigned)((long)K * S), NW1 * 32, WIN1_SMEM,
                  (cudaStream_t)stream>>>(coords(a), (const int*)dig,
                                          (int*)ox, (int*)oy, (int*)oz, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_g2_win_step(LH_WIN_ARGS) {
  const void* a[12] = {xa, ya, za, x1, y1, z1, x2, y2, z2, x3, y3, z3};
  k_g2_win_step<<<(unsigned)((long)K * S), NW2 * 32, WIN2_SMEM,
                  (cudaStream_t)stream>>>(coords(a), (const int*)dig,
                                          (int*)ox, (int*)oy, (int*)oz, S);
  return (int)cudaGetLastError();
}
