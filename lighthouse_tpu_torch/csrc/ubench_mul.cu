// The fused Fp-product microbenchmark: `k_ubench_mul` (one product per
// launch) and `k_ubench_mul_chain` (R products chained in one launch, R a
// kernel argument), the device half of
// lighthouse_tpu_torch/tools/ubench_mul.py.
//
// Replace the reference's Pallas kernels `_kernel` and `_kernel_chain`
// (tools/ubench_pallas.py:85, :93, launched through its pl.pallas_call at
// :107): the round-2 product, with a 3-pass carry normalization at every
// site (both entries, the 73-limb product, and after each of the three
// folds 73 -> 37, 37 -> 36, 36 -> 36), not the lane core's trimmed
// schedule; `_kernel_chain` runs x = mul(x, b) R times on the entry-normed
// operands.
//
// The tables are this library's own: ubench_mul.py hands its FOLDS [36,
// 41] and TOPFM [3, 73] (the microbenchmark's, rebuilt from the round-2
// constants) to lh_ubench_mul_init, which copies them into the constant
// bank and, padded, into global memory (`g_prod`).
//
// Bound on the H100: integer operations (per product 1,296 conv
// multiply-adds, 1,476 fold multiply-adds and 3 x (73 + 37 + 36 + 36)
// limb carry steps, ~8,500 int32 operations, against 432 bytes in and
// out; the chain does R of them on the same bytes). Design: one thread per
// lane element, the limbs and the 73-limb accumulator in registers,
// coalesced loads (neighbouring threads on neighbouring lanes).
//
// `k_ubench_mul` reads the tables from the constant bank (`BankTables`).
// `k_ubench_mul_chain` reads them from the block's copy in shared memory
// (`SharedTables`): a product walks all 5,904 B of FOLDS, more than the
// SM's constant cache holds, so in the bank each warp stalled at issue on
// its misses, and at 110,592 lanes and R = 40 the chain took 6.7x its
// operations bound; from shared memory it takes 1.3x, and 0.27 device ms
// at 4,096 lanes against 1.03 (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).
// The grid holds at most the blocks that fit the card at once, and each
// block walks the batch in steps of the grid, so a wide batch copies the
// 7.2 KB once a resident block, not once every CHAIN_THREADS elements.
// The chain keeps 253 registers a thread, so 8 warps fit an SM whatever
// the block: 32, 64 and 128 threads a block time within 1.5 % of each
// other at 4,096 and 110,592 lanes, 256 is 18 % slower at 4,096 (16
// blocks, 16 SMs) and 4 % faster at 110,592, and a launch bound of 3
// blocks of 128 caps the registers at 168 and spills (6 % slower): 128,
// no bound (`python -m lighthouse_tpu_torch.tools.ubench_mul --sweep`,
// which builds this file with other values through the macros below).
#include <climits>

#include "fp_lane.cuh"

#ifndef UB_CHAIN_THREADS
#define UB_CHAIN_THREADS 128
#endif
#ifndef UB_CHAIN_MIN_BLOCKS
#define UB_CHAIN_MIN_BLOCKS 1
#endif

namespace {

using lh::B;
using lh::CONVW;
using lh::FOLD_AT;
using lh::MASK;
using lh::NFOLD;
using lh::W;

constexpr int PASSES = 3;
constexpr int CHAIN_THREADS = UB_CHAIN_THREADS;
constexpr int CHAIN_MIN_BLOCKS = UB_CHAIN_MIN_BLOCKS;

// ------------------------------ the chain's tables in shared memory
// A copy laid out so that one output limb's k-loop (a FOLDS row) and one
// carry pass (a TOPFM row) read consecutive 16-byte-aligned words, four
// at a time, every thread of a warp the same address (a broadcast):
//
//   FOLDS [W, NFOLD] rows padded to FSTRIDE words | TOPFM [3, CONVW] rows
//   padded to TSTRIDE words; the pads are 0.
//
// The copy is read volatile where it is used: the entries are the same in
// every product of a chain, and a compiler that sees that keeps them in
// registers beside the limbs and spills.
constexpr int FSTRIDE = 44;
constexpr int TSTRIDE = 76;
constexpr int P_FOLDS = 0;
constexpr int P_TOPFM = W * FSTRIDE;
constexpr int P_WORDS = P_TOPFM + 3 * TSTRIDE;
static_assert(FSTRIDE % 4 == 0 && FSTRIDE >= NFOLD && TSTRIDE % 4 == 0 && TSTRIDE >= CONVW,
              "rows of whole int4s");
static_assert(P_TOPFM % 4 == 0 && P_WORDS % 4 == 0, "the copy is whole int4s");
__device__ __align__(16) int g_prod[P_WORDS];

// g_prod from the host tables (FOLDS [W, NFOLD], TOPFM [3, CONVW]).
int copy_prod_tables(const void* folds, const void* topfm) {
  int tab[P_WORDS] = {};
  const int* f = (const int*)folds;
  const int* t = (const int*)topfm;
  for (int i = 0; i < W; ++i) {
    for (int k = 0; k < NFOLD; ++k) tab[P_FOLDS + i * FSTRIDE + k] = f[i * NFOLD + k];
  }
  for (int r = 0; r < 3; ++r) {
    for (int i = 0; i < CONVW; ++i) tab[P_TOPFM + r * TSTRIDE + i] = t[r * CONVW + i];
  }
  return (int)cudaMemcpyToSymbol(g_prod, tab, sizeof(tab));
}

// g_prod into the block's copy, an int4 a thread at a time: all threads
// of the block, one barrier.
__device__ __forceinline__ const int* block_prod_tables() {
  __shared__ __align__(16) int tab[P_WORDS];
  for (int t = threadIdx.x; t < P_WORDS / 4; t += blockDim.x) {
    reinterpret_cast<int4*>(tab)[t] = reinterpret_cast<const int4*>(g_prod)[t];
  }
  __syncthreads();
  return tab;
}

// Words off .. off + n - 1 (n <= 4) of the shared copy at p into f,
// volatile: one int4 load where off is a multiple of 4 and n is 4, one
// int2 where off is even and n is 2, else a word at a time. off and n
// are constants once the callers' loops are unrolled.
__device__ __forceinline__ void lds(const int* p, int off, int n, int* f) {
#ifdef __CUDA_ARCH__
  const unsigned a = (unsigned)__cvta_generic_to_shared(p + off);
  if (n == 4 && off % 4 == 0) {
    asm volatile("ld.volatile.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
                 : "r"(a)
                 : "memory");
  } else if (n == 2 && off % 2 == 0) {
    asm volatile("ld.volatile.shared.v2.s32 {%0, %1}, [%2];"
                 : "=r"(f[0]), "=r"(f[1])
                 : "r"(a)
                 : "memory");
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < n) {
        asm volatile("ld.volatile.shared.s32 %0, [%1];" : "=r"(f[j]) : "r"(a + 4 * j) : "memory");
      }
    }
  }
#else
  const volatile int* v = p + off;
  for (int j = 0; j < n; ++j) f[j] = v[j];
#endif
}

// Where the product reads FOLDS and TOPFM. `BankTables`: the constant bank
// (fp_lane.cuh c_folds, c_topfm, through lh::norm and lh::fold).
struct BankTables {
  template <int N, int P>
  __device__ __forceinline__ void norm(int* x) const {
    lh::norm<N, P>(x);
  }
  template <int N, int OFF>
  __device__ __forceinline__ void fold(const int* x, int* out) const {
    lh::fold<N, OFF>(x, out);
  }
};

// `SharedTables`: the block's copy at `t` (block_prod_tables), the same
// arithmetic in the same order as lh::norm1 and lh::fold.
struct SharedTables {
  const int* t;

  template <int N>
  __device__ __forceinline__ void pass(int* x) const {
    const int top = x[N - 1] >> B;
    int carry = 0;
#pragma unroll
    for (int i0 = 0; i0 < N; i0 += 4) {
      int f[4];
      lds(t, P_TOPFM + lh::trow(N) * TSTRIDE + i0, N - i0 < 4 ? N - i0 : 4, f);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i0 + j < N) {
          const int v = x[i0 + j];
          x[i0 + j] = (v & MASK) + carry + top * f[j];
          carry = v >> B;
        }
      }
    }
  }

  template <int N, int P>
  __device__ __forceinline__ void norm(int* x) const {
#pragma unroll
    for (int p = 0; p < P; ++p) pass<N>(x);
  }

  template <int N, int OFF>
  __device__ __forceinline__ void fold(const int* x, int* out) const {
    constexpr int NK = N - FOLD_AT;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      int s = i < FOLD_AT ? x[i] : 0;
#pragma unroll
      for (int k0 = 0; k0 < NK; k0 += 4) {
        int f[4];
        lds(t, P_FOLDS + i * FSTRIDE + OFF + k0, NK - k0 < 4 ? NK - k0 : 4, f);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k0 + j < NK) s += f[j] * x[FOLD_AT + k0 + j];
        }
      }
      out[i] = s;
    }
  }
};

// ------------------------------------------------------------ kernels

// the blocks of k_ubench_mul_chain that fit the card at once
// (lh_ubench_mul_init)
int g_chain_grid = 0;

// the microbenchmark's `_mul_body` on entry-normed operands, the tables
// read through `tab`; out may alias a
template <class Tab>
__device__ __forceinline__ void ub_mul(int* out, const int* a, const int* b, const Tab& tab) {
  int wide[CONVW];
  lh::conv(a, b, wide);
  tab.template norm<CONVW, PASSES>(wide);
  int x37[37];
  tab.template fold<CONVW, 0>(wide, x37);
  x37[36] = 0;
  tab.template norm<37, PASSES>(x37);
  int x36[W];
  tab.template fold<37, 38>(x37, x36);
  tab.template norm<W, PASSES>(x36);
  tab.template fold<W, 40>(x36, out);
  tab.template norm<W, PASSES>(out);
}

// element `base` of the batch: both operands loaded and normed, then R
// products x <- x b
template <class Tab>
__device__ __forceinline__ void chain_elem(const int* __restrict__ a, const int* __restrict__ b,
                                           int* __restrict__ out, int R, long base, int S,
                                           const Tab& tab) {
  int x[W], y[W];
  lh::load_elem(x, a, base, S);
  lh::load_elem(y, b, base, S);
  tab.template norm<W, PASSES>(x);
  tab.template norm<W, PASSES>(y);
#pragma unroll 1
  for (int r = 0; r < R; ++r) ub_mul(x, x, y, tab);
  lh::store_elem(out, x, base, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_ubench_mul(const int* __restrict__ a, const int* __restrict__ b,
                 int* __restrict__ out, int K, int S) {
  long base;
  if (!lh::elem_index(K, S, &base)) return;
  chain_elem(a, b, out, 1, base, S, BankTables{});
}

__global__ void __launch_bounds__(CHAIN_THREADS, CHAIN_MIN_BLOCKS)
    k_ubench_mul_chain(const int* __restrict__ a, const int* __restrict__ b,
                       int* __restrict__ out, int R, int n, int S) {
  const SharedTables tab{block_prod_tables()};
  for (int i = blockIdx.x * CHAIN_THREADS + threadIdx.x; i < n; i += gridDim.x * CHAIN_THREADS) {
    const int k = i / S, s = i - k * S;
    chain_elem(a, b, out, R, (long)k * W * S + s, S, tab);
  }
}

}  // namespace

LH_EXPORT int lh_ubench_mul_init(const void* folds, const void* topfm) {
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = copy_prod_tables(folds, topfm);
  int dev = 0, sms = 0, per_sm = 0;
  if (!e) e = (int)cudaGetDevice(&dev);
  if (!e) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!e) {
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_ubench_mul_chain,
                                                           CHAIN_THREADS, 0);
  }
  if (!e) g_chain_grid = sms * per_sm;
  return e;
}

LH_EXPORT const char* lh_ubench_mul_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_ubench_mul(const void* a, const void* b, void* out, int K,
                            int S, void* stream) {
  k_ubench_mul<<<lh::blocks_for(K, S), lh::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (int*)out, K, S);
  return (int)cudaGetLastError();
}

// n = K * S lane elements; n plus a grid's threads stays an int
LH_EXPORT int lh_ubench_mul_chain(const void* a, const void* b, void* out,
                                  int R, int K, int S, void* stream) {
  const long n = (long)K * S;
  if (n > INT_MAX / 2 || g_chain_grid <= 0) return (int)cudaErrorInvalidValue;
  const long want = (n + CHAIN_THREADS - 1) / CHAIN_THREADS;
  k_ubench_mul_chain<<<(unsigned)(want < g_chain_grid ? want : g_chain_grid), CHAIN_THREADS,
                       0, (cudaStream_t)stream>>>((const int*)a, (const int*)b, (int*)out, R,
                                                  (int)n, S);
  return (int)cudaGetLastError();
}
