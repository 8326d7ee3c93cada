// Lane-major Fp arithmetic over BLS12-381 as CUDA device functions.
//
// The device half of lighthouse_tpu_torch/ops/lane/fp.py: an element is
// W = 36 signed lazy 11-bit limbs (int32), value = sum(limb[i] << 11*i)
// mod p. In global memory a batch is [stack..., W, S] int32, limb i of
// element (k, s) at (k*W + i)*S + s, so the threads of a warp (one thread
// per element, neighbouring s) read neighbouring addresses.
//
// Each function mirrors one plain PyTorch body (and through it the
// reference's jnp body in lighthouse_tpu/ops/lane/fp.py) operation for
// operation: the same carry passes at the same schedule depths, the same
// fold matrices, the same int32 arithmetic. `>>` on int is arithmetic and
// `& MASK` acts on the two's-complement pattern, as jnp.right_shift and
// jnp.bitwise_and do. No product or sum wraps at these depths (the
// reference's limb-bounds certificate, tests/budgets/limb_bounds.json);
// changing a depth below voids that proof.
#pragma once

#include <cuda_runtime.h>

namespace lh {

constexpr int B = 11;
constexpr int W = 36;
constexpr int MASK = (1 << B) - 1;
constexpr int CONVW = 2 * W + 1;  // 73
constexpr int FOLD_AT = 35;
constexpr int NFOLD = 41;         // FOLDS columns: [full 38 | 2 | 1]
// canonical()'s width: 36 limbs padded by one for the ripples
constexpr int W37 = W + 1;
constexpr int LADDER_ROUNDS = 7;  // fp._LADDER_ROUNDS: values < p * 2^7

// Carry-pass depths, copied from `_SCHED` (ops/lane/fp.py).
constexpr int MUL_ENTRY_A = 2;
constexpr int MUL_ENTRY_B = 2;
constexpr int MUL_WIDE = 2;
constexpr int MUL_FOLD37 = 0;
constexpr int MUL_FOLD36 = 0;
constexpr int MUL_FOLD35 = 1;
constexpr int SQR_ENTRY = 1;
constexpr int RL_ENTRY = 0;
constexpr int RL_FOLD_A = 0;
constexpr int RL_FOLD_B = 1;
constexpr int NORM3_KERNEL = 2;
// canon.* sites are OPEN (value-preserving) passes
constexpr int CANON_ENTRY = 0;
constexpr int CANON_FOLD_A = 0;
constexpr int CANON_FOLD_B = 1;
constexpr int CANON_FOLD_C = 1;
constexpr int CANON_FOLD_D = 0;

// FOLDS [W, 41] and TOPFM [3, CONVW], row-major; every thread of a warp
// reads the same entry at the same time, which constant memory broadcasts.
// Aligned: the bank places them after the cooperative programs
// (coop_programs.h), and at an offset that is not a multiple of 8 ptxas
// reads neighbouring entries one word at a time, not in 64-bit pairs
// (`k_f2mul` took 44 % longer so).
static __constant__ __align__(16) int c_folds[W * NFOLD];
static __constant__ __align__(16) int c_topfm[3 * CONVW];

// topfold row by carry width (`_TROW`): 73 -> 0, 37 -> 1, 36 -> 2
__host__ __device__ constexpr int trow(int n) {
  return n == CONVW ? 0 : (n == 37 ? 1 : 2);
}

// One carry pass (`_norm1`): out[i] = lo[i] + hi[i-1] + hi[top] * topf[i],
// topf TOPFM's row for N limbs (default: the constant bank's).
template <int N, class Tab = const int*>
__device__ __forceinline__ void norm1(int* x, Tab tf = c_topfm + trow(N) * CONVW) {
  const int top = x[N - 1] >> B;
  int carry = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int v = x[i];
    x[i] = (v & MASK) + carry + top * tf[i];
    carry = v >> B;
  }
}

// One value-preserving pass (`_norm1_open`): the top limb keeps its own
// carry, lo_top + 2^B * hi_top == top, and takes the carry from below.
template <int N>
__device__ __forceinline__ void norm1_open(int* x) {
  int carry = 0;
#pragma unroll
  for (int i = 0; i < N - 1; ++i) {
    const int v = x[i];
    x[i] = (v & MASK) + carry;
    carry = v >> B;
  }
  x[N - 1] += carry;
}

template <int N, int PASSES, bool OPEN = false>
__device__ __forceinline__ void norm(int* x) {
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    if (OPEN) {
      norm1_open<N>(x);
    } else {
      norm1<N>(x);
    }
  }
}

// Schoolbook limb product (`_conv`): acc[i+j] += a[i]*b[j]; limbs 71 and
// 72 stay 0.
__device__ __forceinline__ void conv(const int* a, const int* b, int* acc) {
#pragma unroll
  for (int k = 0; k < CONVW; ++k) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
#pragma unroll
    for (int j = 0; j < W; ++j) acc[i + j] += a[i] * b[j];
  }
}

// `_fold(x, folds[:, 40:41])`, 36 limbs -> 36, through a FOLDS column
// read at col[i * STRIDE]: NFOLD in the whole FOLDS table, 1 where the
// column is packed.
template <int STRIDE, class Col>
__device__ __forceinline__ void fold_col(const int* x, int* out, Col col) {
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = (i < FOLD_AT ? x[i] : 0) + col[i * STRIDE] * x[FOLD_AT];
}

// `_canon_reduce_body`, in place: open passes and four single-row folds
// through FOLDS column 40, at `f40` with its entries STRIDE words apart
// (a cooperative kernel passes its block's copy of FOLDS in shared
// memory, `canonical` and `canon_reduce` their packed column).
template <int STRIDE, class Col>
__device__ __forceinline__ void canon_reduce_body(int* x, Col f40) {
  int t[W];
  norm<W, CANON_ENTRY, true>(x);
  fold_col<STRIDE>(x, t, f40);
  norm<W, CANON_FOLD_A, true>(t);
  fold_col<STRIDE>(t, x, f40);
  norm<W, CANON_FOLD_B, true>(x);
  fold_col<STRIDE>(x, t, f40);
  norm<W, CANON_FOLD_C, true>(t);
  fold_col<STRIDE>(t, x, f40);
  norm<W, CANON_FOLD_D, true>(x);
}

// ------------------------------------ tables in the block's shared memory
// `canonical` and `reduce_light`, one thread per lane element, read the
// table entries on their chains from the block's copy in shared memory,
// not the constant bank: an instruction whose constant operand misses
// stalls the warp at issue, and FOLDS column 40's entries lie 41 words
// apart, each on its own line of the bank. The copy is read volatile,
// each entry where it is used (a cached copy would sit in registers beside
// the limbs).
//
// In global memory, int32: KP [37] | PK_LADDER [7, 37] | FOLDS column 40
// [36] | TOPFM's row for 36 limbs [36], padded to whole int4s.
constexpr int T_KP = 0;
constexpr int T_LADDER = W37;
constexpr int T_F40 = T_LADDER + LADDER_ROUNDS * W37;
constexpr int T_TF = T_F40 + W;
constexpr int T_WORDS = (T_TF + W + 3) / 4 * 4;
static_assert(T_F40 % 4 == 0 && T_TF % 4 == 0, "the copies start and end at whole int4s");
static __device__ __align__(16) int g_short[T_WORDS];

// g_short from the host tables (FOLDS [W, 41], TOPFM [3, CONVW], KP [37],
// PK_LADDER [7, 37]; the last two may be null: their words stay 0).
static inline int copy_short_tables(const void* folds, const void* topfm, const void* kp37,
                                    const void* pk_ladder) {
  int tab[T_WORDS] = {};
  for (int i = 0; i < W37 && kp37; ++i) tab[T_KP + i] = ((const int*)kp37)[i];
  for (int i = 0; i < LADDER_ROUNDS * W37 && pk_ladder; ++i) {
    tab[T_LADDER + i] = ((const int*)pk_ladder)[i];
  }
  for (int i = 0; i < W; ++i) {
    tab[T_F40 + i] = ((const int*)folds)[i * NFOLD + 40];
    tab[T_TF + i] = ((const int*)topfm)[trow(W) * CONVW + i];
  }
  return (int)cudaMemcpyToSymbol(g_short, tab, sizeof(tab));
}

// Words [FROM, TO) of g_short into the block's copy, an int4 a thread
// at a time: all threads of the block, one barrier. Word FROM + i is the
// copy's word i.
template <int FROM, int TO>
__device__ __forceinline__ const volatile int* block_tables() {
  static_assert(FROM % 4 == 0 && TO % 4 == 0 && FROM < TO, "whole int4s");
  __shared__ __align__(16) int tab[TO - FROM];
  for (int t = threadIdx.x; t < (TO - FROM) / 4; t += blockDim.x) {
    reinterpret_cast<int4*>(tab)[t] = reinterpret_cast<const int4*>(g_short + FROM)[t];
  }
  __syncthreads();
  return tab;
}

// `_reduce_light_body` in place: FOLDS column 40 packed at `f40`, TOPFM's
// row for W limbs at `tf` (the block's copy).
__device__ __forceinline__ void reduce_light_body(int* x, const volatile int* f40,
                                                  const volatile int* tf) {
  int t[W];
#pragma unroll
  for (int p = 0; p < RL_ENTRY; ++p) norm1<W>(x, tf);
  fold_col<1>(x, t, f40);
#pragma unroll
  for (int p = 0; p < RL_FOLD_A; ++p) norm1<W>(t, tf);
  fold_col<1>(t, x, f40);
#pragma unroll
  for (int p = 0; p < RL_FOLD_B; ++p) norm1<W>(x, tf);
}

// ---------------------------------------------------------- global I/O
// Element (k, s) of a [K, W, S] batch: limb i at (k*W + i)*S + s.
__device__ __forceinline__ void load_elem(int* out, const int* __restrict__ g,
                                          long base, int S) {
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = g[base + (long)i * S];
}

__device__ __forceinline__ void store_elem(int* __restrict__ g, const int* v,
                                           long base, int S) {
#pragma unroll
  for (int i = 0; i < W; ++i) g[base + (long)i * S] = v[i];
}

// Thread -> (k, s); false past the ragged edge of K*S elements.
__device__ __forceinline__ bool elem_index(int K, int S, long* base) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)K * S) return false;
  const long k = t / S;
  const long s = t - k * S;
  *base = k * W * S + s;
  return true;
}

constexpr int THREADS = 128;

inline unsigned blocks_for(int K, int S) {
  return (unsigned)(((long)K * S + THREADS - 1) / THREADS);
}

// Copy FOLDS / TOPFM (host int32 arrays) into this module's constant bank.
static inline int copy_consts(const void* folds, const void* topfm) {
  cudaError_t e = cudaMemcpyToSymbol(c_folds, folds, sizeof(c_folds));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_topfm, topfm, sizeof(c_topfm));
  return (int)e;
}

}  // namespace lh

// Every library exports its error-string helper under its own name.
#define LH_EXPORT extern "C" __attribute__((visibility("default")))
