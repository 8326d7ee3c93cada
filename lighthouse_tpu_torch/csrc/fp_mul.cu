// K1: the Fp product `mul` and square `sqr`, both cooperative, one warp
// per lane element.
//
// Replaces the Pallas kernels `mul` and `sqr` of the reference
// (lighthouse_tpu/ops/lane/fp.py `_mul_fn` / `_sqr_fn` -> `_mul_body`,
// registered through `kernel_op`'s pl.pallas_call).
//
// Bound on the H100: integer operations. Per element the kernel reads 2
// (sqr: 1) x 144 bytes and writes 144, but does 1,296 conv multiply-adds,
// 1,476 fold multiply-adds and ~330 limb carry steps: some 7,300 int32
// operations for 432 bytes, far above the card's ops-per-byte balance.
//
// Each runs a one-job program (ops/lane/coop.py, traced from `_mul_fn`:
// one MUL job, both entry norms; from `_sqr_fn`: one SQR job, the
// sqr.entry pass) laid out one warp per lane element (coop.cuh
// `run_warp`): the product limb-parallel across the warp's lanes, as
// every cooperative kernel's jobs, the tables in the block's shared
// memory. Their launches are small: `mul` 12 and 2 lane elements (the
// final exponentiation's frob2 and f2inv), 1,024 and 2 x 1,024 (the affine
// conversions' f2inv at the bucket's width); `sqr` one launch a verify,
// 1 x 128 or 1 x 1,024 (`_to_affine_g1`). One thread an element ran the
// 7,300 operations in a row there and left most SMs idle: `sqr` so took
// 0.029 ms at 1 x 1,024, about as long as at 4,096 lanes. A block of NW
// warps copies FOLDS and TOPFM into shared memory once and takes NW lane
// elements at a time, one a warp, their operands loaded and their
// products stored by the whole block along the lanes (neighbouring
// threads on neighbouring addresses). The grid holds at most as many
// blocks as fit the card at once, and a block walks the batch in steps of
// the grid, so a wide batch copies the tables once a block, not once an
// element. The one template below is both kernels' loop, over the
// operand count.
//
// The other layout for `sqr`, one thread an element with its tables in
// the block's shared memory (as `k_ubench_mul_chain` reads them), was
// measured against this one and lost at every width: 0.0104-0.0120 device
// ms a launch at 1 x 128 and 1 x 1,024 (32 or 64 threads a block) against
// 0.0045-0.0050, one warp's serial chain of some 8,000 instructions
// against the product spread over 32 lanes (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6).
#include <climits>

#include "coop.cuh"
#include "coop_programs.h"
#include "fp_lane.cuh"

namespace {

using lh::W;

// warps a block (lane elements a block at a time), from ops/lane/coop.py
// PROGRAMS
constexpr int MUL_NW = lh::coop::MUL_WARPS;
constexpr int SQR_NW = lh::coop::SQR_WARPS;
static_assert(lh::coop::MUL_INS == 2 && lh::coop::MUL_OUTS == 1, "mul: a, b -> a b");
static_assert(lh::coop::SQR_INS == 1 && lh::coop::SQR_OUTS == 1, "sqr: a -> a^2");
// the dynamic shared memory each block launches with
constexpr int MUL_SMEM = 4 * lh::coop::warp_smem_ints(MUL_NW, lh::coop::MUL_ROWS);
constexpr int SQR_SMEM = 4 * lh::coop::warp_smem_ints(SQR_NW, lh::coop::SQR_ROWS);
static_assert(MUL_SMEM <= 227 * 1024 && SQR_SMEM <= 227 * 1024, "a block's shared memory");

// the blocks of k_mul and k_sqr that fit the card at once (lh_fp_mul_init)
int g_mul_grid = 0;
int g_sqr_grid = 0;

// A one-job program `prog` of NIN operands (a, then b) over the n lane
// elements of a [K, W, S] batch, NW a block, one a warp.
template <int NW, int ROWS, int NIN>
__device__ __forceinline__ void per_warp(const int* prog, const int* __restrict__ a,
                                         const int* __restrict__ b, int* __restrict__ out,
                                         int n, int S) {
  constexpr int R = ROWS * W;  // one warp's rows
  int* smem = lh::coop::dyn_smem();
  lh::coop::setup<NW>(smem);
  __syncthreads();
  const lh::coop::Lane c = lh::coop::lane_consts(smem);
  const int w = threadIdx.x >> 5;
  int* rows = smem + lh::coop::warp_rows(NW, ROWS, 0);
  for (int e0 = blockIdx.x * NW; e0 < n; e0 += gridDim.x * NW) {
    // lane element e0 + e of the batch into warp e's rows: a, then b
    // (program rows 0 and 1); thread t takes element t % NW
    for (int t = threadIdx.x; t < NW * NIN * W; t += NW * 32) {
      const int e = t % NW, r = t / NW, i = e0 + e;
      if (i < n) {
        const int k = i / S, s = i - k * S;
        rows[e * R + r] = (r < W ? a : b)[(long)k * W * S + s + (long)(r % W) * S];
      }
    }
    __syncthreads();
    if (e0 + w < n) {  // uniform over the warp
      lh::coop::run_warp(prog, smem, lh::coop::warp_rows(NW, ROWS, w),
                         lh::coop::TABLES + w * lh::coop::SCRATCH, c);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < NW * W; t += NW * 32) {
      const int e = t % NW, l = t / NW, i = e0 + e;
      if (i < n) {
        const int k = i / S, s = i - k * S;
        out[(long)k * W * S + s + (long)l * S] = lh::coop::out_value(prog, rows + e * R, 0, l);
      }
    }
    __syncthreads();  // the rows read, before the next elements overwrite them
  }
}

__global__ void __launch_bounds__(MUL_NW * 32, lh::coop::min_blocks(MUL_NW))
    k_mul(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
          int n, int S) {
  per_warp<MUL_NW, lh::coop::MUL_ROWS, 2>(lh::coop::c_prog_mul, a, b, out, n, S);
}

__global__ void __launch_bounds__(SQR_NW * 32, lh::coop::min_blocks(SQR_NW))
    k_sqr(const int* __restrict__ a, int* __restrict__ out, int n, int S) {
  per_warp<SQR_NW, lh::coop::SQR_ROWS, 1>(lh::coop::c_prog_sqr, a, a, out, n, S);
}

// the kernel's shared memory attribute set, and the blocks of it that fit
// the card at once into *grid
template <class Kernel>
int size_grid(Kernel kernel, int nw, int smem, int* grid) {
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (!e) e = (int)cudaGetDevice(&dev);
  if (!e) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nw * 32, smem);
  if (!e) *grid = sms * per_sm;
  return e;
}

// blocks for n lane elements, nw a block, at most `grid`
unsigned blocks(long n, int nw, int grid) {
  const long b = (n + nw - 1) / nw;
  return (unsigned)(b < grid ? b : grid);
}

}  // namespace

LH_EXPORT int lh_fp_mul_init(const void* folds, const void* topfm) {
  int e = lh::coop::copy_tables(folds, topfm);
  if (!e) e = size_grid(k_mul, MUL_NW, MUL_SMEM, &g_mul_grid);
  if (!e) e = size_grid(k_sqr, SQR_NW, SQR_SMEM, &g_sqr_grid);
  return e;
}

// The dynamic shared memory (bytes) a block of program `slot` (coop.py
// PROGRAMS: mul, sqr) launches with; -1 for another slot.
LH_EXPORT int lh_fp_mul_launch_smem(int slot) {
  return slot == lh::coop::MUL_SLOT ? MUL_SMEM : (slot == lh::coop::SQR_SLOT ? SQR_SMEM : -1);
}

LH_EXPORT const char* lh_fp_mul_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_fp_mul(const void* a, const void* b, void* out, int K, int S,
                        void* stream) {
  const long n = (long)K * S;
  if (n > INT_MAX || g_mul_grid <= 0) return (int)cudaErrorInvalidValue;
  k_mul<<<blocks(n, MUL_NW, g_mul_grid), MUL_NW * 32, MUL_SMEM, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (int*)out, (int)n, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_fp_sqr(const void* a, void* out, int K, int S, void* stream) {
  const long n = (long)K * S;
  if (n > INT_MAX || g_sqr_grid <= 0) return (int)cudaErrorInvalidValue;
  k_sqr<<<blocks(n, SQR_NW, g_sqr_grid), SQR_NW * 32, SQR_SMEM, (cudaStream_t)stream>>>(
      (const int*)a, (int*)out, (int)n, S);
  return (int)cudaGetLastError();
}
