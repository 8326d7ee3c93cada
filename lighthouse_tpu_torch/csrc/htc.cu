// The ratio chain of hash-to-G2, w^((p^2 - 9) / 16) = conj(w)^e1 w^e0, as
// one kernel (ops/lane/htc.py `ratio_chain`): a 16-entry table
// conj(w)^i w^j (i, j < 4), then 191 MSB-first joint 2-bit windows from
// entry 0, each acc <- acc^4 * table[digit].
//
// It replaces, on the port's main path, the chain of the reference's Pallas
// kernels `f2sqr` and `f2mul` (lighthouse_tpu/ops/lane/tower.py:217-218)
// that `htc.ratio_chain` (lighthouse_tpu/ops/lane/htc.py:98) launches one
// Fp2 operation at a time: 383 `f2sqr` and 193 `f2mul` launches a chain
// (1,369 Fp products, 402 reduce_light). The limbs are those launches',
// operation for operation.
//
// Cooperative (coop.cuh): one block per lane element, each Fp product or
// reduce_light one warp's job, the element's rows in shared memory. A
// program holds no loop, so the chain is two programs (ops/lane/coop.py,
// traced from `_ratio_table_body` and `_ratio_win_body`): the table's (5
// stages, 52 jobs on 41 rows: w, 1 -> the 16 entries) runs once; the
// window's (4 stages of 2, 2, 3, 2 jobs on 7 rows: acc, E -> acc^4 E) runs
// once a digit. The digits are the same on every lane element, so they sit
// in the constant bank (`c_ratio_idx`) and each window's entry is a
// block-uniform pick. The entries live in 32 rows above the window
// program's rows; between runs the block moves the previous output and
// the window's entry into the window's input rows.
//
// Bound on the H100: integer operations at width (1,369 Fp products and
// 402 reduce_light a lane element against 2 x 288 bytes in and out); at
// one lane element, the latency of 769 serial stages.
#include "coop.cuh"
#include "coop_programs.h"

namespace {

using lh::W;

// warps per lane element, from ops/lane/coop.py PROGRAMS: one block runs
// both programs
constexpr int NW = lh::coop::RATIO_TABLE_WARPS;
static_assert(lh::coop::RATIO_WIN_WARPS == NW, "both programs run on one block's warps");
static_assert(lh::coop::RATIO_TABLE_INS == 4 && lh::coop::RATIO_TABLE_OUTS == 32,
              "ratio_table: w, 1 -> 16 entries");
static_assert(lh::coop::RATIO_WIN_INS == 4 && lh::coop::RATIO_WIN_OUTS == 2,
              "ratio_win: acc, E -> acc^4 E");

constexpr int ENTRY_ROWS = lh::coop::RATIO_TABLE_OUTS;  // 16 entries of 2 rows
constexpr int TABLE_AT = lh::coop::RATIO_WIN_ROWS;      // the entries' first row
constexpr int ROWS = lh::coop::RATIO_TABLE_ROWS > TABLE_AT + ENTRY_ROWS
                         ? lh::coop::RATIO_TABLE_ROWS
                         : TABLE_AT + ENTRY_ROWS;
// the dynamic shared memory each block launches with (coop.py kernel_stats)
constexpr int SMEM = 4 * lh::coop::smem_ints(NW, ROWS);
static_assert(SMEM <= 227 * 1024, "a block's shared memory");

__global__ void __launch_bounds__(NW * 32, lh::coop::min_blocks(NW))
    k_ratio_chain(const int* __restrict__ w, int* __restrict__ out, int S) {
  const int* table_prog = lh::coop::c_prog_ratio_table;
  const int* win_prog = lh::coop::c_prog_ratio_win;
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  // rows 0-1: w; rows 2-3: the 1 (entry 0) the chain starts from
  lh::coop::load<NW>(rows, w, 2, k, s, S);
  for (int i = threadIdx.x; i < 2 * W; i += NW * 32) rows[2 * W + i] = i == 0;
  __syncthreads();
  lh::coop::run<NW>(table_prog, smem);

  // The entries into rows TABLE_AT.., which the table program's own rows
  // overlap: every output limb read, a barrier, then every one written.
  constexpr int N = ENTRY_ROWS * W;
  constexpr int PER = (N + NW * 32 - 1) / (NW * 32);
  int v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int t = threadIdx.x + j * NW * 32;
    v[j] = t < N ? lh::coop::out_limb(table_prog, smem, NW, t / W, t % W) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int t = threadIdx.x + j * NW * 32;
    if (t < N) rows[TABLE_AT * W + t] = v[j];
  }
  __syncthreads();

  // The windows. Thread i moves limb i of the accumulator (entry 0, then
  // the previous output) into rows 0-1 and limb i of the digit's entry
  // into rows 2-3. The previous output may lie in rows 0-3 itself, but
  // only thread i reads or writes any row's limb i, and it reads all four
  // before it writes: one barrier a window.
  for (int n = 0; n < lh::coop::RATIO_WINDOWS; ++n) {
    const int* e = rows + (TABLE_AT + 2 * lh::coop::c_ratio_idx[n]) * W;
    for (int i = threadIdx.x; i < W; i += NW * 32) {
      const int a0 = n ? lh::coop::out_limb(win_prog, smem, NW, 0, i) : rows[TABLE_AT * W + i];
      const int a1 = n ? lh::coop::out_limb(win_prog, smem, NW, 1, i)
                       : rows[(TABLE_AT + 1) * W + i];
      const int e0 = e[i], e1 = e[W + i];
      rows[i] = a0;
      rows[W + i] = a1;
      rows[2 * W + i] = e0;
      rows[3 * W + i] = e1;
    }
    __syncthreads();
    lh::coop::run<NW>(win_prog, smem);
  }
  for (int t = threadIdx.x; t < 2 * W; t += NW * 32) {
    out[lh::coop::at(2, t / W, t % W, k, s, S)] =
        lh::coop::out_limb(win_prog, smem, NW, t / W, t % W);
  }
}

}  // namespace

LH_EXPORT int lh_htc_init(const void* folds, const void* topfm) {
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = lh::coop::copy_tables(folds, topfm);
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_ratio_chain, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM);
  }
  return e;
}

// The dynamic shared memory (bytes) a block of `ratio_chain` launches with,
// asked by the slot of either of its programs (coop.py PROGRAMS:
// ratio_table, ratio_win); -1 for another slot.
LH_EXPORT int lh_htc_launch_smem(int slot) {
  return slot == lh::coop::RATIO_TABLE_SLOT || slot == lh::coop::RATIO_WIN_SLOT ? SMEM : -1;
}

LH_EXPORT const char* lh_htc_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_ratio_chain(const void* w, void* out, int K, int S, void* stream) {
  k_ratio_chain<<<(unsigned)((long)K * S), NW * 32, SMEM, (cudaStream_t)stream>>>(
      (const int*)w, (int*)out, S);
  return (int)cudaGetLastError();
}
