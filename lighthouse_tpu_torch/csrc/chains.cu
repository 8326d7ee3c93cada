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
// `g1_win_step` keeps one thread per lane element over `lh::win_step<Fp1>`
// (jac.cuh): the accumulator, the table and the temporaries in the
// thread's local memory.
//
// `g2_win_step` is cooperative (coop.cuh): a block of G2_WIN_STEP_WARPS
// warps per lane element. Its program, traced by ops/lane/coop.py from
// `_win_core_f2` (the two doublings and add-2007-bl without its selection:
// 23 stages of 129 jobs, 75 of them products, on 53 rows), maps (acc, E)
// to ([4]acc, [4]acc + E). The selects of the plain body are uniform over
// the block, one lane element, so they only choose rows: the block reads
// its digit and loads T[digit] as E, tests E's Z before the program and
// [4]acc's Z after it (`__syncthreads_or`), then writes [4]acc, E or the
// sum in the body's order of precedence (`_win_select`).
#include "coop.cuh"
#include "coop_programs.h"
#include "jac.cuh"

namespace {

using lh::W;

// the 12 coordinate operands travel by value in one struct
struct Coords {
  const int* p[12];
};

__global__ void __launch_bounds__(lh::THREADS)
    k_g1_win_step(Coords in, const int* __restrict__ dig, int* __restrict__ ox,
                  int* __restrict__ oy, int* __restrict__ oz, int K, int S) {
  long k, s;
  if (!lh::lane_index(K, S, &k, &s)) return;
  // acc, T1, T2, T3: three coordinates each, back to back
  int pts[4][3 * W];
#pragma unroll 1
  for (int p = 0; p < 4; ++p) {
#pragma unroll 1
    for (int c = 0; c < 3; ++c) lh::load_rows<1>(pts[p] + c * W, in.p[3 * p + c], k, s, S);
  }
  const int d = dig[k * S + s];
  lh::win_step<lh::Fp1>(pts[0], pts[1], pts[2], pts[3], d, pts[0]);
  lh::store_rows<1>(ox, pts[0], k, s, S);
  lh::store_rows<1>(oy, pts[0] + W, k, s, S);
  lh::store_rows<1>(oz, pts[0] + 2 * W, k, s, S);
}

// ------------------------------------------------------------ cooperative

constexpr int NW = lh::coop::G2_WIN_STEP_WARPS;  // from ops/lane/coop.py PROGRAMS
static_assert(lh::coop::G2_WIN_STEP_INS == 12 && lh::coop::G2_WIN_STEP_OUTS == 12,
              "g2_win_step: acc, E -> [4]acc, [4]acc + E");
// the dynamic shared memory each block launches with
constexpr int WIN_SMEM = 4 * lh::coop::smem_ints(NW, lh::coop::G2_WIN_STEP_ROWS);

using lh::coop::at;
using lh::coop::c_prog_g2_win_step;

// Coordinate c of the table entry of digit d: T3 for 3, T2 for 2, T1 for
// 0 and 1 (constant indices: a dynamic index into the parameter struct
// would copy it to the stack).
__device__ __forceinline__ const int* entry(const Coords& in, int d, int c) {
  return d == 3 ? in.p[9 + c] : (d == 2 ? in.p[6 + c] : in.p[3 + c]);
}

__global__ void __launch_bounds__(NW * 32, lh::coop::min_blocks(NW))
    k_g2_win_step(Coords in, const int* __restrict__ dig, int* __restrict__ ox,
                  int* __restrict__ oy, int* __restrict__ oz, int S) {
  const int* prog = c_prog_g2_win_step;
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  const int d = dig[k * S + s];
  const int* e[3] = {entry(in, d, 0), entry(in, d, 1), entry(in, d, 2)};
  // the program's input rows: acc (X, Y, Z, 2 each), then E = T[d]
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lh::coop::load<NW>(rows + 2 * c * W, in.p[c], 2, k, s, S);
    lh::coop::load<NW>(rows + (6 + 2 * c) * W, e[c], 2, k, s, S);
  }
  __syncthreads();
  // structural infinity (`_is_zero`: every limb of both components 0) of
  // E's Z, rows 10-11, before the program may reuse them ...
  int nz = 0;
  for (int t = threadIdx.x; t < 2 * W; t += NW * 32) nz |= rows[10 * W + t];
  const bool p2_inf = !__syncthreads_or(nz);
  lh::coop::run<NW>(prog, smem);
  // ... and of [4]acc's Z, outputs 4-5
  nz = 0;
  for (int t = threadIdx.x; t < 2 * W; t += NW * 32) {
    nz |= lh::coop::out_limb(prog, smem, NW, 4 + t / W, t % W);
  }
  const bool p1_inf = !__syncthreads_or(nz);
  // `_win_select`: digit 0 -> [4]acc; else P1 = [4]acc at infinity -> E;
  // else E at infinity -> [4]acc; else the sum (outputs 6-11)
  const bool pick_e = d != 0 && p1_inf;
  const int first = (d == 0 || p2_inf) ? 0 : 6;
  for (int t = threadIdx.x; t < 6 * W; t += NW * 32) {
    const int o = t / W, i = t - o * W;  // coordinate o / 2, component o % 2
    const long a = at(2, o % 2, i, k, s, S);
    const int* src = o < 2 ? e[0] : (o < 4 ? e[1] : e[2]);
    (o < 2 ? ox : (o < 4 ? oy : oz))[a] =
        pick_e ? src[a] : lh::coop::out_limb(prog, smem, NW, first + o, i);
  }
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
    e = (int)cudaFuncSetAttribute(k_g2_win_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  WIN_SMEM);
  }
  return e;
}

// The dynamic shared memory (bytes) a block of program `slot` (coop.py
// PROGRAMS: g2_win_step) launches with; -1 for another slot.
LH_EXPORT int lh_chains_launch_smem(int slot) {
  return slot == lh::coop::G2_WIN_STEP_SLOT ? WIN_SMEM : -1;
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
  k_g2_win_step<<<(unsigned)((long)K * S), NW * 32, WIN_SMEM,
                  (cudaStream_t)stream>>>(coords(a), (const int*)dig,
                                          (int*)ox, (int*)oy, (int*)oz, S);
  return (int)cudaGetLastError();
}
