// The Fermat inversions a^(p-2) as one kernel each: `inv_w4`, the MSB-first
// 4-bit windowed chain (ops/lane/chains.py `pow_const_w4`: a 16-entry power
// table, then 4 squares and one table product a window), and `inv_bin`, the
// LSB-first binary chain (ops/lane/fp.py `pow_const`: a product on each set
// bit, a square on every bit).
//
// They replace, on the port's paths, the chains of the reference's Pallas
// kernels `mul` and `sqr` (lighthouse_tpu/ops/lane/fp.py:440-441) that
// `chains.inv` (lighthouse_tpu/ops/lane/chains.py:88, `pow_const_w4` :71)
// and `fp.inv` (lighthouse_tpu/ops/lane/fp.py:540, `pow_const` :518)
// launch one product at a time: 385 squares and 99 launches of products
// (109 products: the table's are stacked) an `inv_w4`, 381 squares and 229
// products an `inv_bin`. The limbs are those launches', product for
// product.
//
// Both are cooperative (coop.cuh): one block per lane element, each Fp
// product or square one warp's job, the element's rows in shared memory.
// Their programs, traced by ops/lane/coop.py from `_inv_w4_body` and
// `_inv_bin_body`, are serial chains: `inv_w4` 480 stages of one job (494
// jobs on 18 rows; 1 warp), `inv_bin` 381 stages, a bit's product and the
// next square side by side (609 jobs on 89 rows; 2 warps). Each stage ends
// at a block barrier, so at one lane element a call takes the stages times
// one job's latency. The program's second input row is the 1 the chains
// start from, written here (fp.ONE: limb 0 is 1, the rest 0), not read.
//
// Bound on the H100: integer operations at width (494 or 609 Fp products a
// lane element against 2 x 144 bytes); at one lane element, the latency of
// the serial chain.
#include "coop.cuh"
#include "coop_programs.h"

namespace {

using lh::W;

// warps per lane element, from ops/lane/coop.py PROGRAMS
constexpr int W4_WARPS = lh::coop::INV_W4_WARPS;
constexpr int BIN_WARPS = lh::coop::INV_BIN_WARPS;
static_assert(lh::coop::INV_W4_INS == 2 && lh::coop::INV_W4_OUTS == 1, "inv_w4: a, 1 -> a^(p-2)");
static_assert(lh::coop::INV_BIN_INS == 2 && lh::coop::INV_BIN_OUTS == 1,
              "inv_bin: a, 1 -> a^(p-2)");

// the dynamic shared memory each block launches with
constexpr int W4_SMEM = 4 * lh::coop::smem_ints(W4_WARPS, lh::coop::INV_W4_ROWS);
constexpr int BIN_SMEM = 4 * lh::coop::smem_ints(BIN_WARPS, lh::coop::INV_BIN_ROWS);
static_assert(W4_SMEM <= 227 * 1024 && BIN_SMEM <= 227 * 1024, "a block's shared memory");

// Lane element (k, s) of a [K, W, S] batch through program `prog`: rows
// a and 1, the chain, the output row.
template <int NW>
__device__ __forceinline__ void chain(const int* prog, const int* __restrict__ a,
                                      int* __restrict__ out, int S) {
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  lh::coop::load<NW>(rows, a, 1, k, s, S);
  for (int i = threadIdx.x; i < W; i += NW * 32) rows[W + i] = i == 0;
  __syncthreads();
  lh::coop::run<NW>(prog, smem);
  for (int i = threadIdx.x; i < W; i += NW * 32) {
    out[lh::coop::at(1, 0, i, k, s, S)] = lh::coop::out_limb(prog, smem, NW, 0, i);
  }
}

__global__ void __launch_bounds__(W4_WARPS * 32, lh::coop::min_blocks(W4_WARPS))
    k_inv_w4(const int* __restrict__ a, int* __restrict__ out, int S) {
  chain<W4_WARPS>(lh::coop::c_prog_inv_w4, a, out, S);
}

__global__ void __launch_bounds__(BIN_WARPS * 32, lh::coop::min_blocks(BIN_WARPS))
    k_inv_bin(const int* __restrict__ a, int* __restrict__ out, int S) {
  chain<BIN_WARPS>(lh::coop::c_prog_inv_bin, a, out, S);
}

}  // namespace

LH_EXPORT int lh_inv_init(const void* folds, const void* topfm) {
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = lh::coop::copy_tables(folds, topfm);
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_inv_w4, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  W4_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_inv_bin, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  BIN_SMEM);
  }
  return e;
}

// The dynamic shared memory (bytes) a block of program `slot` (coop.py
// PROGRAMS: inv_w4, inv_bin) launches with; -1 for another slot.
LH_EXPORT int lh_inv_launch_smem(int slot) {
  return slot == lh::coop::INV_W4_SLOT ? W4_SMEM
                                       : (slot == lh::coop::INV_BIN_SLOT ? BIN_SMEM : -1);
}

LH_EXPORT const char* lh_inv_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_inv_w4(const void* a, void* out, int K, int S, void* stream) {
  k_inv_w4<<<(unsigned)((long)K * S), W4_WARPS * 32, W4_SMEM, (cudaStream_t)stream>>>(
      (const int*)a, (int*)out, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_inv_bin(const void* a, void* out, int K, int S, void* stream) {
  k_inv_bin<<<(unsigned)((long)K * S), BIN_WARPS * 32, BIN_SMEM, (cudaStream_t)stream>>>(
      (const int*)a, (int*)out, S);
  return (int)cudaGetLastError();
}
