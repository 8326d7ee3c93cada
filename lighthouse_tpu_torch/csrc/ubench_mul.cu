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
// operands, `_kernel` once.
//
// The tables are this library's own: ubench_mul.py hands its FOLDS [36,
// 41] and TOPFM [3, 73] (the microbenchmark's, rebuilt from the round-2
// constants) to lh_ubench_mul_init, which copies them, padded, into global
// memory (`g_prod`); neither kernel reads the constant bank.
//
// Bound on the H100: integer operations (per product 1,296 conv
// multiply-adds, 1,476 fold multiply-adds and 3 x (73 + 37 + 36 + 36)
// limb carry steps, ~8,500 int32 operations, against 432 bytes in and
// out; the chain does R of them on the same bytes). Design: one thread per
// lane element, the limbs and the 73-limb accumulator in registers,
// coalesced loads (neighbouring threads on neighbouring lanes).
//
// Both kernels run one body, `walk`: R products of each lane element
// (`k_ubench_mul` with R = 1 fixed at compile time), the tables read from
// the block's copy of `g_prod` in shared memory (`SharedTables`). A
// product walks all 5,904 B of FOLDS, more than the SM's constant cache
// holds, so from the bank each warp stalled at issue on its misses: at
// 110,592 lanes the chain (R = 40) took 6.7x its operations bound and the
// single product 0.100 device ms, 3.2x; from shared memory 1.3x and
// 0.048, 1.55x (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6). The grid holds
// at most the blocks that fit the card at once, and each block walks the
// batch in steps of the grid, so a wide batch copies the 7.2 KB once a
// resident block. A thread's first operands load before the table copy,
// under its latency: 4 % off the single product at 110,592 against
// loading them after it, 1-4 % against a loop rotated to load each next
// pair early too. The single product keeps 255 registers a thread and the
// chain 247, 0 B spills, so an SM holds 8 warps at 32, 64, 128 and 256
// threads a block but 6 at 96 and 192. One launch shape for both, 128
// threads and no launch bound: in a sweep of this body at 4,096 and
// 110,592 lanes, 32, 64, 96, 192 and 256 a block are 3-28 % slower for
// the single product at 110,592 and 1-20 % at 4,096; for the chain 32,
// 64 and 256 are within 1 % at 110,592 (256 20 % slower at 4,096), 96
// and 192 29-36 % slower there (96 0.2 % faster at 4,096); a launch
// bound of 2 blocks moves either under 1 %. (`python -m
// lighthouse_tpu_torch.tools.ubench_mul --sweep ...` builds this file
// with other values through the macros below.)
#include <climits>

#include "fp_lane.cuh"

#ifndef UB_THREADS
#define UB_THREADS 128
#endif
#ifndef UB_MIN_BLOCKS
#define UB_MIN_BLOCKS 1
#endif

namespace {

using lh::B;
using lh::CONVW;
using lh::FOLD_AT;
using lh::MASK;
using lh::NFOLD;
using lh::W;

constexpr int PASSES = 3;
constexpr int THREADS = UB_THREADS;
constexpr int MIN_BLOCKS = UB_MIN_BLOCKS;

// ------------------------------------- the tables in shared memory
// A copy laid out so that one output limb's k-loop (a FOLDS row) and one
// carry pass (a TOPFM row) read consecutive 16-byte-aligned words, four
// at a time, every thread of a warp the same address (a broadcast):
//
//   FOLDS [W, NFOLD] rows padded to FSTRIDE words | TOPFM [3, CONVW] rows
//   padded to TSTRIDE words; the pads are 0.
//
// The copy is read volatile where it is used: the entries are the same in
// every product of a chain and in the two entry norms, and a compiler that
// sees that keeps them in registers beside the limbs and spills.
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

// FOLDS and TOPFM read from the block's copy at `t` (block_prod_tables),
// the same arithmetic in the same order as fp_lane.cuh's lh::norm1 and
// lh::fold.
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

// the blocks of each kernel that fit the card at once (lh_ubench_mul_init)
int g_mul_grid = 0;
int g_chain_grid = 0;

// the microbenchmark's `_mul_body` on entry-normed operands; out may
// alias a
__device__ __forceinline__ void ub_mul(int* out, const int* a, const int* b,
                                       const SharedTables& tab) {
  int wide[CONVW];
  lh::conv(a, b, wide);
  tab.norm<CONVW, PASSES>(wide);
  int x37[37];
  tab.fold<CONVW, 0>(wide, x37);
  x37[36] = 0;
  tab.norm<37, PASSES>(x37);
  int x36[W];
  tab.fold<37, 38>(x37, x36);
  tab.norm<W, PASSES>(x36);
  tab.fold<W, 40>(x36, out);
  tab.norm<W, PASSES>(out);
}

// The n = K * S lane elements, THREADS a block, the block's threads
// stepping by the grid's: each element's operands normed, then R products
// x <- x b. A thread's first operands are loaded before the table copy,
// their latency under the copy's.
__device__ __forceinline__ void walk(const int* __restrict__ a, const int* __restrict__ b,
                                     int* __restrict__ out, int R, int n, int S) {
  const int first = blockIdx.x * THREADS + threadIdx.x;
  int x[W], y[W];
  if (first < n) {
    const int k = first / S, s = first - k * S;
    const long base = (long)k * W * S + s;
    lh::load_elem(x, a, base, S);
    lh::load_elem(y, b, base, S);
  }
  const SharedTables tab{block_prod_tables()};
  for (int i = first; i < n; i += gridDim.x * THREADS) {
    const int k = i / S, s = i - k * S;
    const long base = (long)k * W * S + s;
    if (i != first) {
      lh::load_elem(x, a, base, S);
      lh::load_elem(y, b, base, S);
    }
    tab.norm<W, PASSES>(x);
    tab.norm<W, PASSES>(y);
#pragma unroll 1
    for (int r = 0; r < R; ++r) ub_mul(x, x, y, tab);
    lh::store_elem(out, x, base, S);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    k_ubench_mul(const int* __restrict__ a, const int* __restrict__ b,
                 int* __restrict__ out, int n, int S) {
  walk(a, b, out, 1, n, S);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    k_ubench_mul_chain(const int* __restrict__ a, const int* __restrict__ b,
                       int* __restrict__ out, int R, int n, int S) {
  walk(a, b, out, R, n, S);
}

// the blocks of `kernel`, THREADS a block, that fit the card at once
// into *grid
template <class Kernel>
int size_grid(Kernel kernel, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  int e = (int)cudaGetDevice(&dev);
  if (!e) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (!e) *grid = sms * per_sm;
  return e;
}

// blocks for n lane elements, THREADS a block, at most `grid`
unsigned blocks(long n, int grid) {
  const long b = (n + THREADS - 1) / THREADS;
  return (unsigned)(b < grid ? b : grid);
}

}  // namespace

LH_EXPORT int lh_ubench_mul_init(const void* folds, const void* topfm) {
  int e = copy_prod_tables(folds, topfm);
  if (!e) e = size_grid(k_ubench_mul, &g_mul_grid);
  if (!e) e = size_grid(k_ubench_mul_chain, &g_chain_grid);
  return e;
}

LH_EXPORT const char* lh_ubench_mul_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// n = K * S lane elements; n plus a grid's threads stays an int
LH_EXPORT int lh_ubench_mul(const void* a, const void* b, void* out, int K,
                            int S, void* stream) {
  const long n = (long)K * S;
  if (n > INT_MAX / 2 || g_mul_grid <= 0) return (int)cudaErrorInvalidValue;
  k_ubench_mul<<<blocks(n, g_mul_grid), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (int*)out, (int)n, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_ubench_mul_chain(const void* a, const void* b, void* out,
                                  int R, int K, int S, void* stream) {
  const long n = (long)K * S;
  if (n > INT_MAX / 2 || g_chain_grid <= 0) return (int)cudaErrorInvalidValue;
  k_ubench_mul_chain<<<blocks(n, g_chain_grid), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (int*)out, R, (int)n, S);
  return (int)cudaGetLastError();
}
