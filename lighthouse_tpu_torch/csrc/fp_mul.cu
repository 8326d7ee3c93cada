// K1: Fp product `mul` (cooperative, one warp per lane element) and `sqr`
// (one thread per lane element).
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
// `mul` runs a one-job program (ops/lane/coop.py, traced from `_mul_fn`:
// one MUL job, both entry norms) laid out one warp per lane element
// (coop.cuh `run_warp`): the product limb-parallel across the warp's
// lanes, as every cooperative kernel's jobs. Its launches are small: 12
// and 2 lane elements (the final exponentiation's frob2 and f2inv), 1,024
// and 2 x 1,024 (the affine conversions' f2inv at the bucket's width),
// where one thread an element ran the 7,300 operations in a row and left
// most SMs idle. A block of MUL_WARPS warps copies FOLDS and TOPFM into
// shared memory once and takes MUL_WARPS lane elements at a time, one a
// warp, their operands loaded and their products stored by the whole
// block along the lanes (neighbouring threads on neighbouring addresses).
// The grid holds at most as many blocks as fit the card at once, and a
// block walks the batch in steps of the grid, so a wide batch copies the
// tables once a block, not once an element.
//
// `sqr` keeps one thread per lane element: all limbs in registers (a and
// the 73-limb accumulator, ~150 live values), the fold matrices in
// constant memory (one broadcast read per warp), coalesced loads
// (neighbouring threads hold neighbouring lanes).
#include <climits>

#include "coop.cuh"
#include "coop_programs.h"
#include "fp_lane.cuh"

namespace {

using lh::W;

__global__ void __launch_bounds__(lh::THREADS)
    k_sqr(const int* __restrict__ a, int* __restrict__ out, int K, int S) {
  long base;
  if (!lh::elem_index(K, S, &base)) return;
  int x[lh::W], r[lh::W];
  lh::load_elem(x, a, base, S);
  lh::sqr_body(r, x);
  lh::store_elem(out, r, base, S);
}

// ------------------------------------------------------------ cooperative

// warps a block (lane elements a block at a time), from ops/lane/coop.py
// PROGRAMS
constexpr int MUL_NW = lh::coop::MUL_WARPS;
constexpr int MUL_ROWS = lh::coop::MUL_ROWS;
static_assert(lh::coop::MUL_INS == 2 && lh::coop::MUL_OUTS == 1, "mul: a, b -> a b");
// the dynamic shared memory each block launches with
constexpr int MUL_SMEM = 4 * lh::coop::warp_smem_ints(MUL_NW, MUL_ROWS);
static_assert(MUL_SMEM <= 227 * 1024, "a block's shared memory");

// the blocks of k_mul that fit the card at once (lh_fp_mul_init)
int g_mul_grid = 0;

__global__ void __launch_bounds__(MUL_NW * 32, lh::coop::min_blocks(MUL_NW))
    k_mul(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
          int n, int S) {
  constexpr int NW = MUL_NW;
  constexpr int R = MUL_ROWS * W;  // one warp's rows
  const int* prog = lh::coop::c_prog_mul;
  int* smem = lh::coop::dyn_smem();
  lh::coop::setup<NW>(smem);
  __syncthreads();
  const lh::coop::Lane c = lh::coop::lane_consts(smem);
  const int w = threadIdx.x >> 5;
  int* rows = smem + lh::coop::warp_rows(NW, MUL_ROWS, 0);
  for (int e0 = blockIdx.x * NW; e0 < n; e0 += gridDim.x * NW) {
    // lane element e0 + e of the [K, W, S] batch into warp e's rows: a,
    // then b (program rows 0 and 1); thread t takes element t % NW
    for (int t = threadIdx.x; t < NW * 2 * W; t += NW * 32) {
      const int e = t % NW, r = t / NW, i = e0 + e;
      if (i < n) {
        const int k = i / S, s = i - k * S;
        rows[e * R + r] = (r < W ? a : b)[(long)k * W * S + s + (long)(r % W) * S];
      }
    }
    __syncthreads();
    if (e0 + w < n) {  // uniform over the warp
      lh::coop::run_warp(prog, smem, lh::coop::warp_rows(NW, MUL_ROWS, w),
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

}  // namespace

LH_EXPORT int lh_fp_mul_init(const void* folds, const void* topfm) {
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = lh::coop::copy_tables(folds, topfm);
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_mul, cudaFuncAttributeMaxDynamicSharedMemorySize, MUL_SMEM);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if (!e) e = (int)cudaGetDevice(&dev);
  if (!e) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!e) {
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_mul, MUL_NW * 32,
                                                           MUL_SMEM);
  }
  if (!e) g_mul_grid = sms * per_sm;
  return e;
}

// The dynamic shared memory (bytes) a block of program `slot` (coop.py
// PROGRAMS: mul) launches with; -1 for another slot.
LH_EXPORT int lh_fp_mul_launch_smem(int slot) {
  return slot == lh::coop::MUL_SLOT ? MUL_SMEM : -1;
}

LH_EXPORT const char* lh_fp_mul_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_fp_mul(const void* a, const void* b, void* out, int K, int S,
                        void* stream) {
  const long n = (long)K * S;
  if (n > INT_MAX || g_mul_grid <= 0) return (int)cudaErrorInvalidValue;
  const long blocks = (n + MUL_NW - 1) / MUL_NW;
  k_mul<<<(unsigned)(blocks < g_mul_grid ? blocks : g_mul_grid), MUL_NW * 32, MUL_SMEM,
          (cudaStream_t)stream>>>((const int*)a, (const int*)b, (int*)out, (int)n, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_fp_sqr(const void* a, void* out, int K, int S, void* stream) {
  k_sqr<<<lh::blocks_for(K, S), lh::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)a, (int*)out, K, S);
  return (int)cudaGetLastError();
}
