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
// field temporaries in local memory. The ladder steps (ladder.cu) run
// both programs too, with the doubling's.
//
// K4a: `add_exact_f1`, the exact add over Fp (G1) in one kernel: the
// reference's `add(FP1, p1, p2, exact=True)` (lighthouse_tpu/ops/lane/
// jacobian.py:267), which launches `jac_add_f1`, 2 `sqr` and 6 `mul` for
// the collision check H = U2 - U1, R = S2 - S1, 2 `canon_reduce` for its
// canonical() compares (their ripples and ladder as XLA glue) and a
// `jac_dbl_f1`, and selects around them. The check's products are the
// add's own U1, U2, S1, S2, so one program (`_add_exact_core_f1`: 7
// stages of 31 jobs, 23 of them products and squares, on 21 rows) maps
// (P1, P2) to the sum, the doubling of P1 and the lazy H and R. The
// epilogue, uniform over the block: Z1 and Z2 tested before the program
// may reuse their rows; where neither is at infinity, the collision
// check: the block copies canonical()'s KP and ladder into the warps'
// scratch, free once the program has run, beside H's and R's limbs, which
// it evaluates a limb a thread; then one thread each runs canonical() of
// H and of R in registers (csrc/canon.cuh: canon_reduce through the
// block's FOLDS, the ripples, the ladder's signed form) and tests every
// limb for 0, and the two flags reach the block by `__syncthreads_or`;
// then `_add_exact_select`'s five cases: the doubling (outputs 3C ..),
// infinity (zeros), P2, P1 (each re-read from global memory) or the sum.
// The tables sit in shared memory, not the constant bank (an instruction
// whose constant operand misses stalls the warp where it issues, and the
// chain's 36 FOLDS entries alone lie on 36 lines of the bank), and are
// read as volatile, each where it is used: a copy kept in registers
// spills at the kernel's 64.
// A template over the component count C like `add`, instantiated over Fp.
//
// Bound on the H100: integer operations (the add's 16 Fp products, the
// doubling's 7 and the two canonical() chains, ~170,000 int32 operations
// per pair against 1,296 bytes).
#include "canon.cuh"
#include "coop.cuh"
#include "coop_programs.h"

namespace {

using lh::W;

// warps per lane element, from ops/lane/coop.py PROGRAMS
constexpr int NW1 = lh::coop::JAC_ADD_F1_WARPS;
constexpr int NW2 = lh::coop::JAC_ADD_F2_WARPS;
constexpr int NWX1 = lh::coop::ADD_EXACT_F1_WARPS;
static_assert(lh::coop::JAC_ADD_F1_INS == 6 && lh::coop::JAC_ADD_F1_OUTS == 3,
              "jac_add_f1: P1, P2 -> P1 + P2");
static_assert(lh::coop::JAC_ADD_F2_INS == 12 && lh::coop::JAC_ADD_F2_OUTS == 6,
              "jac_add_f2: P1, P2 -> P1 + P2");
static_assert(lh::coop::ADD_EXACT_F1_INS == 6 && lh::coop::ADD_EXACT_F1_OUTS == 8,
              "add_exact_f1: P1, P2 -> P1 + P2, [2]P1, H, R");
// the dynamic shared memory each block launches with
constexpr int ADD_F1_SMEM = 4 * lh::coop::smem_ints(NW1, lh::coop::JAC_ADD_F1_ROWS);
constexpr int ADD_F2_SMEM = 4 * lh::coop::smem_ints(NW2, lh::coop::JAC_ADD_F2_ROWS);
constexpr int EXACT_F1_SMEM = 4 * lh::coop::smem_ints(NWX1, lh::coop::ADD_EXACT_F1_ROWS);

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

// canonical()'s KP [37] then PK_LADDER [7, 37] in global memory, for the
// block's copy in shared memory (its threads read different entries)
constexpr int CANON_WORDS = lh::W37 * (1 + lh::LADDER_ROUNDS);
static __device__ int g_canon[CANON_WORDS];

// `_add_exact_flags`' H === 0 and R === 0: canonical() of the program's
// outputs 6C .. 7C - 1 (H) and 7C .. 8C - 1 (R), each component on lane 0
// of its own warp, every limb tested for 0; the flags reach the whole
// block. All threads of the block: three block barriers. The warps'
// scratch holds the tables and the 2C operands.
template <int NW, int C>
__device__ __forceinline__ void collision(const int* prog, int* smem, bool* h_zero,
                                          bool* r_zero) {
  static_assert(NW * lh::coop::SCRATCH >= CANON_WORDS + 2 * C * lh::W37,
                "the warps' scratch holds canonical()'s tables and H and R");
  int* tab = smem + lh::coop::TABLES;
  int* ops = tab + CANON_WORDS;
  const volatile int* vtab = tab;
  for (int t = threadIdx.x; t < CANON_WORDS; t += NW * 32) tab[t] = g_canon[t];
  for (int t = threadIdx.x; t < 2 * C * W; t += NW * 32) {
    const int o = t / W, i = t - o * W;
    ops[o * lh::W37 + i] = lh::coop::out_limb(prog, smem, NW, 6 * C + o, i);
  }
  __syncthreads();
  int h_nz = 0, r_nz = 0;
  for (int j = threadIdx.x >> 5; j < 2 * C; j += NW) {
    if ((threadIdx.x & 31) == 0) {
      int v[lh::W37];
#pragma unroll
      for (int i = 0; i < W; ++i) v[i] = ops[j * lh::W37 + i];
      lh::canonical_body<lh::Ladder::kSigned>(v, vtab, vtab + lh::W37, (const volatile int*)smem + 40);
      int nz = 0;
#pragma unroll
      for (int i = 0; i < W; ++i) nz |= v[i];
      if (j < C) {
        h_nz |= nz;
      } else {
        r_nz |= nz;
      }
    }
  }
  *h_zero = !__syncthreads_or(h_nz);
  *r_zero = !__syncthreads_or(r_nz);
}

// The exact add of lane element blockIdx.x through program `prog`, over
// points of C rows a coordinate.
template <int NW, int C>
__device__ __forceinline__ void add_exact(const int* prog, const int* __restrict__ x1,
                                          const int* __restrict__ y1,
                                          const int* __restrict__ z1,
                                          const int* __restrict__ x2,
                                          const int* __restrict__ y2,
                                          const int* __restrict__ z2, int* __restrict__ ox,
                                          int* __restrict__ oy, int* __restrict__ oz, int S) {
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  lh::coop::load_point<NW, C>(rows, x1, y1, z1, k, s, S);
  lh::coop::load_point<NW, C>(rows + 3 * C * W, x2, y2, z2, k, s, S);
  __syncthreads();
  const bool p1_inf = lh::coop::rows_zero<NW>(rows + 2 * C * W, C);
  const bool p2_inf = lh::coop::rows_zero<NW>(rows + 5 * C * W, C);
  lh::coop::run<NW>(prog, smem);
  // the collision check applies where neither point is at infinity
  const bool either_inf = p1_inf || p2_inf;
  bool h_zero = false, r_zero = false;
  if (!either_inf) collision<NW, C>(prog, smem, &h_zero, &r_zero);
  // `_add_exact_select`: H === R === 0 -> the doubling (outputs 3C ..
  // 6C - 1); H === 0 -> infinity; else `_add_select`: P1 at infinity ->
  // P2, P2 at infinity -> P1, else the sum (outputs 0 .. 3C - 1)
  lh::coop::store_point<NW, C>(prog, smem, h_zero && r_zero ? 3 * C : 0, either_inf,
                               p1_inf ? x2 : x1, p1_inf ? y2 : y1, p1_inf ? z2 : z1, ox, oy,
                               oz, k, s, S, h_zero && !r_zero);
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

__global__ void __launch_bounds__(NWX1 * 32, lh::coop::min_blocks(NWX1))
    k_add_exact_f1(const int* __restrict__ x1, const int* __restrict__ y1,
                   const int* __restrict__ z1, const int* __restrict__ x2,
                   const int* __restrict__ y2, const int* __restrict__ z2,
                   int* __restrict__ ox, int* __restrict__ oy, int* __restrict__ oz, int S) {
  add_exact<NWX1, 1>(lh::coop::c_prog_add_exact_f1, x1, y1, z1, x2, y2, z2, ox, oy, oz, S);
}

}  // namespace

// FOLDS, TOPFM, then canonical()'s KP_37 and PK_LADDER (kernels.INIT_TABLES).
LH_EXPORT int lh_jac_add_init(const void* folds, const void* topfm, const void* kp37,
                              const void* pk_ladder) {
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = lh::coop::copy_tables(folds, topfm);
  if (!e) e = (int)cudaMemcpyToSymbol(g_canon, kp37, 4 * lh::W37);
  if (!e) {
    e = (int)cudaMemcpyToSymbol(g_canon, pk_ladder, 4 * lh::LADDER_ROUNDS * lh::W37,
                                4 * lh::W37);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_jac_add_f1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  ADD_F1_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_jac_add_f2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  ADD_F2_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_add_exact_f1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  EXACT_F1_SMEM);
  }
  return e;
}

// The dynamic shared memory (bytes) a block of program `slot` (coop.py
// PROGRAMS: jac_add_f1, jac_add_f2, add_exact_f1) launches with; -1 for
// another slot.
LH_EXPORT int lh_jac_add_launch_smem(int slot) {
  if (slot == lh::coop::JAC_ADD_F1_SLOT) return ADD_F1_SMEM;
  if (slot == lh::coop::JAC_ADD_F2_SLOT) return ADD_F2_SMEM;
  return slot == lh::coop::ADD_EXACT_F1_SLOT ? EXACT_F1_SMEM : -1;
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

LH_EXPORT int lh_add_exact_f1(const void* x1, const void* y1, const void* z1,
                              const void* x2, const void* y2, const void* z2,
                              void* ox, void* oy, void* oz, int K, int S,
                              void* stream) {
  k_add_exact_f1<<<(unsigned)((long)K * S), NWX1 * 32, EXACT_F1_SMEM,
                   (cudaStream_t)stream>>>(
      (const int*)x1, (const int*)y1, (const int*)z1, (const int*)x2,
      (const int*)y2, (const int*)z2, (int*)ox, (int*)oy, (int*)oz, S);
  return (int)cudaGetLastError();
}
