// Cooperative lane-element kernels: a thread block of NW warps works on one
// lane element, whose state lives in the block's shared memory as rows of
// W limbs; each Fp product, square and reduce_light is one warp's job.
//
// The device half of lighthouse_tpu_torch/ops/lane/coop.py, which traces a
// kernel's program from its plain body and writes it into the generated
// header coop_programs.h, a `__constant__` array, with the program's slot
// and warps per element. A program is a list of jobs in stages: the
// jobs of a stage are independent, the block's warps take them in turn
// (warp w: jobs w, w + NW, ...), and a block barrier ends the stage. A job
// reads its operands as lazy sums, integer combinations of rows evaluated
// limb by limb (the order of the adds is free: the sums are exact inside
// the limb-bounds certificate), and writes one row.
//
// Within a job the warp is limb-parallel, lane l holding limb l and, on
// lanes 0-3, limb 32 + l (the 73 columns of a product: l, 32 + l, 64 + l):
// - a carry pass (`norm1`) is one `__shfl_sync` for the limb below and one
//   broadcast of the top limb, with `_SCHED`'s depths at every site;
// - the 36 x 36 convolution gives each lane three columns: the A limbs are
//   broadcast by shuffle, the B limbs read from the warp's zero-padded copy
//   in shared memory (BPAD ints), so every column is a fixed 36-term loop;
// - no lane takes a branch of its own: a select on the lane is an AND with
//   an opaque mask, a store of lanes 4-31's upper register goes to the
//   warp's dump row (a branch would split the warp before each shuffle);
// - a fold is a dot product of the top limbs (broadcast) with a FOLDS row
//   per lane, read from the block's copy of FOLDS in shared memory (a row
//   stride of 41 ints puts the 32 lanes in 32 banks).
// Every value is the one the plain body (ops/lane/fp.py `_mul_body`,
// `_sqr_fn`, `_reduce_light_body`) computes, limb for limb.
#pragma once

#include "fp_lane.cuh"

namespace lh {
namespace coop {

// mirrored from ops/lane/coop.py (pinned by tests/test_torch_coop.py)
constexpr int MUL = 0;
constexpr int RL = 1;
constexpr int SQR = 2;
constexpr int H_STAGES = 0;
constexpr int H_JOBS = 1;
constexpr int H_ROWS = 2;
constexpr int H_OUTS = 3;
constexpr int H_INS = 4;
constexpr int H_STAGE0 = 5;
constexpr int JOB_WORDS = 3;  // kind | na << 8 | nb << 16, out row, term offset
constexpr int OUT_WORDS = 2;  // term offset, term count
constexpr int BPAD = 132;     // B at [36, 72), zeros around: column k, term i at 36 + k - i
constexpr int SCRATCH = 164;  // a warp's scratch: the padded B, a dump row of 32
static_assert(SCRATCH == BPAD + 32, "");

constexpr unsigned FULL = 0xffffffffu;

static_assert(MUL_FOLD37 == 0, "the warp product keeps no 37-limb carry pass");

// FOLDS [W, 41] then TOPFM [3, CONVW] in global memory, for the block's
// copy in shared memory: the lanes read different entries at once, which
// constant memory would serialize.
constexpr int TABLES = W * NFOLD + 3 * CONVW;
static __device__ int g_tables[TABLES];

static inline int copy_tables(const void* folds, const void* topfm) {
  cudaError_t e = cudaMemcpyToSymbol(g_tables, folds, 4 * W * NFOLD);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_tables, topfm, 4 * 3 * CONVW, 4 * W * NFOLD);
  return (int)e;
}

// The blocks of NW warps an SM must hold at once for a launch bound of at
// most 64 registers a thread (an SM has 65,536): with 4 warps, 8 blocks,
// so a 1,024-lane bucket takes one wave of the H100's 132 SMs.
__host__ __device__ constexpr int min_blocks(int nw) { return nw < 32 ? 32 / nw : 1; }

// Shared memory of one block: the tables, NW warp scratches, the rows.
__host__ __device__ constexpr int smem_ints(int nw, int rows) {
  return TABLES + nw * SCRATCH + rows * W;
}

// A value the compiler cannot see through. Lane-dependent selects are
// written as AND masks of opaque values: a select on the lane that the
// compiler can see, it may hoist out of a loop and turn into a branch,
// which splits the warp in front of every shuffle.
__device__ __forceinline__ int opaque(int v) {
#ifdef __CUDA_ARCH__
  asm volatile("mov.b32 %0, %0;" : "+r"(v));
#endif
  return v;
}

// Per-lane constants: the topfold entries and the two single-row fold
// columns of the limbs (columns) this lane holds, its row of FOLDS for the
// upper limb, and the masks (-1 or 0) of lanes 0-2, 0-3, 0-8 and 31.
struct Lane {
  int l;
  int tf73[3];
  int tf36[2];
  int f38[2];
  int f40[2];
  int row1;
  int m3, m4, m9, m31;
};

__device__ __forceinline__ Lane lane_consts(const int* tables) {
  const int* folds = tables;
  const int* topfm = tables + W * NFOLD;
  Lane c;
  c.l = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int col = c.l + 32 * r;
    c.tf73[r] = col < CONVW ? topfm[trow(CONVW) * CONVW + col] : 0;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int limb = c.l + 32 * r;
    c.tf36[r] = limb < W ? topfm[trow(W) * CONVW + limb] : 0;
    c.f38[r] = limb < W ? folds[limb * NFOLD + 38] : 0;
    c.f40[r] = limb < W ? folds[limb * NFOLD + 40] : 0;
  }
  c.row1 = (c.l < W - 32 ? 32 + c.l : c.l) * NFOLD;
  c.m3 = -(c.l < FOLD_AT - 32);
  c.m4 = -(c.l < W - 32);
  c.m9 = -(c.l < CONVW - 64);
  c.m31 = -(c.l == 31);
  return c;
}

// The limb below each held limb (0 below limb 0): lane l - 1's, and lane
// 31's lower register for lane 0's upper one.
__device__ __forceinline__ int below(int lo, int hi, const Lane& c) {
  return __shfl_sync(FULL, hi ^ ((hi ^ lo) & opaque(c.m31)), (c.l + 31) & 31);
}

// One carry pass (`norm1<W>`) over limbs x0 (l) and x1 (32 + l, l < 4).
__device__ __forceinline__ void pass36(int& x0, int& x1, const Lane& c) {
  const int top = __shfl_sync(FULL, x1, W - 1 - 32) >> B;
  const int p0 = below(0, x0, c);
  const int p1 = below(x0, x1, c);
  x0 = (x0 & MASK) + (p0 >> B) + top * c.tf36[0];
  x1 = ((x1 & MASK) + (p1 >> B) + top * c.tf36[1]) & opaque(c.m4);
}

// One carry pass (`norm1<CONVW>`) over columns x0, x1, x2 (l + 32 r).
__device__ __forceinline__ void pass73(int& x0, int& x1, int& x2, const Lane& c) {
  const int top = __shfl_sync(FULL, x2, CONVW - 1 - 64) >> B;
  const int p0 = below(0, x0, c);
  const int p1 = below(x0, x1, c);
  const int p2 = below(x1, x2, c);
  x0 = (x0 & MASK) + (p0 >> B) + top * c.tf73[0];
  x1 = (x1 & MASK) + (p1 >> B) + top * c.tf73[1];
  x2 = ((x2 & MASK) + (p2 >> B) + top * c.tf73[2]) & opaque(c.m9);
}

template <int PASSES>
__device__ __forceinline__ void norm36(int& x0, int& x1, const Lane& c) {
#pragma unroll
  for (int p = 0; p < PASSES; ++p) pass36(x0, x1, c);
}

// `fold<W, 40>` in place: limb 35 folded down through FOLDS column 40.
__device__ __forceinline__ void fold40(int& x0, int& x1, const Lane& c) {
  const int top = __shfl_sync(FULL, x1, FOLD_AT - 32);
  x0 += c.f40[0] * top;
  x1 = (x1 & opaque(c.m3)) + c.f40[1] * top;
}

// A lazy operand at the lane's limbs: sum of coef * row over n terms
// (row << 8 | coef & 0xFF). Unsigned adds: the wrap-free sum, in any order.
// Every lane reads an upper limb (lanes 4-31 another lane's) and masks it.
__device__ __forceinline__ void operand(const int* arena, const int* t, int n,
                                        const Lane& c, int& v0, int& v1) {
  unsigned s0 = 0, s1 = 0;
  for (int k = 0; k < n; ++k) {
    const int w = t[k];
    const unsigned coef = (unsigned)(((w & 0xFF) ^ 0x80) - 0x80);
    const int* row = arena + (w >> 8) * W;
    s0 += coef * (unsigned)row[c.l];
    s1 += coef * (unsigned)row[32 + (c.l & 3)];
  }
  v0 = (int)s0;
  v1 = (int)s1 & opaque(c.m4);
}

// Row `out` (an index into smem) <- (x0, x1); lanes 4-31 write their upper
// register into the warp's dump instead.
__device__ __forceinline__ void store_row(int* smem, int out, int dump, int x0, int x1,
                                          const Lane& c) {
  smem[out + c.l] = x0;
  const int hi = out + 32 + (c.l & 3);
  smem[dump + c.l + ((hi - dump - c.l) & opaque(c.m4))] = x1;
}

// `_mul_body` (kind MUL) or `_sqr_fn` (kind SQR) by one warp: the
// entry norms (a product's two at mul.entry_a/b, a square's one at
// sqr.entry, its operand then both factors), convolution, 73-column carry
// passes, the folds 73 -> 36 (+ a zero limb 36), 37 -> 36, 36 -> 36.
// The result goes to row index `out` of smem (`dump`: the warp's dump row).
__device__ __forceinline__ void job_mul(int* smem, const int* arena, const int* t, int kind,
                                        int na, int nb, int out, int dump, int* bpad,
                                        const Lane& c) {
  int a0, a1, b0, b1;
  operand(arena, t, na, c, a0, a1);
  if (kind == SQR) {
    norm36<SQR_ENTRY>(a0, a1, c);
    b0 = a0;
    b1 = a1;
  } else {
    operand(arena, t + na, nb, c, b0, b1);
    norm36<MUL_ENTRY_A>(a0, a1, c);
    norm36<MUL_ENTRY_B>(b0, b1, c);
  }
  __syncwarp();  // the warp's last product has read its B
  bpad[36 + c.l] = b0;
  bpad[68 + c.l] = b1;  // 0 on lanes 4-31: the pad stays 0
  __syncwarp();
  int x0 = 0, x1 = 0, x2 = 0;  // columns l, 32 + l, 64 + l
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int ai = __shfl_sync(FULL, i < 32 ? a0 : a1, i & 31);
    x0 += ai * bpad[36 + c.l - i];
    x1 += ai * bpad[68 + c.l - i];
    x2 += ai * bpad[100 + c.l - i];
  }
#pragma unroll
  for (int p = 0; p < MUL_WIDE; ++p) pass73(x0, x1, x2, c);
  // fold<CONVW, 0>: limbs 35..72 through FOLDS columns 0..37
  const int* f0 = smem + c.l * NFOLD;  // FOLDS, at the start of smem
  const int* f1 = smem + c.row1;
  int y0 = x0;
  int y1 = x1 & opaque(c.m3);
#pragma unroll
  for (int k = 0; k < CONVW - FOLD_AT; ++k) {
    const int col = FOLD_AT + k;
    const int v = __shfl_sync(FULL, col < 64 ? x1 : x2, col & 31);
    y0 += f0[k] * v;
    y1 += f1[k] * v;
  }
  y1 &= opaque(c.m4);
  // fold<37, 38> of (y, 0): limb 35 through column 38 (limb 36 is 0)
  {
    const int top = __shfl_sync(FULL, y1, FOLD_AT - 32);
    y0 += c.f38[0] * top;
    y1 = (y1 & opaque(c.m3)) + c.f38[1] * top;
  }
  norm36<MUL_FOLD36>(y0, y1, c);
  fold40(y0, y1, c);
  norm36<MUL_FOLD35>(y0, y1, c);
  store_row(smem, out, dump, y0, y1, c);
}

// `reduce_light_body` of a lazy operand by one warp.
__device__ __forceinline__ void job_rl(int* smem, const int* arena, const int* t, int n,
                                       int out, int dump, const Lane& c) {
  int x0, x1;
  operand(arena, t, n, c, x0, x1);
  norm36<RL_ENTRY>(x0, x1, c);
  fold40(x0, x1, c);
  norm36<RL_FOLD_A>(x0, x1, c);
  fold40(x0, x1, c);
  norm36<RL_FOLD_B>(x0, x1, c);
  store_row(smem, out, dump, x0, x1, c);
}

// The block's shared memory: the tables, then NW zeroed warp scratches,
// then the rows.
template <int NW>
__device__ __forceinline__ int* setup(int* smem) {
  for (int i = threadIdx.x; i < TABLES; i += NW * 32) smem[i] = g_tables[i];
  int* scratch = smem + TABLES;
  for (int i = threadIdx.x; i < NW * SCRATCH; i += NW * 32) scratch[i] = 0;
  return scratch + NW * SCRATCH;
}

// The block's dynamic shared memory.
__device__ __forceinline__ int* dyn_smem() {
  extern __shared__ int lh_smem[];
  return lh_smem;
}

// Block -> lane element (k, s) of the K x S grid: one block per element.
__device__ __forceinline__ void block_elem(int S, long* k, long* s) {
  *k = (long)blockIdx.x / S;
  *s = (long)blockIdx.x - *k * S;
}

// The index of limb i of row r of lane element (k, s) of a [K, C rows of
// W, S] batch.
__device__ __forceinline__ long at(int C, int r, int i, long k, long s, int S) {
  return k * C * W * S + s + (long)(r * W + i) * S;
}

// Rows [C x W] of lane element (k, s) of a [K, C rows of W, S] batch into
// shared memory, all threads of the block.
template <int NW>
__device__ __forceinline__ void load(int* rows, const int* __restrict__ g, int C,
                                     long k, long s, int S) {
  const long base = k * C * W * S + s;
  for (int r = threadIdx.x; r < C * W; r += NW * 32) rows[r] = g[base + (long)r * S];
}

// The job at `job` (its words) of `prog` by the calling warp, on the rows
// at index `rows` of smem, with the warp's scratch at index `scratch`.
__device__ __forceinline__ void run_job(const int* prog, const int* job, int* smem, int rows,
                                        int scratch, const Lane& c) {
  const int w0 = job[0];
  const int* t = prog + job[2];
  const int out = rows + job[1] * W;
  const int kind = w0 & 0xFF;  // one kind a job: uniform over the warp
  if (kind == RL) {
    job_rl(smem, smem + rows, t, (w0 >> 8) & 0xFF, out, scratch + BPAD, c);
  } else {
    job_mul(smem, smem + rows, t, kind, (w0 >> 8) & 0xFF, (w0 >> 16) & 0xFF, out,
            scratch + BPAD, smem + scratch, c);
  }
}

// Run every stage of `prog` (the block's warps share each stage's jobs).
template <int NW>
__device__ __forceinline__ void run(const int* prog, int* smem) {
  const int rows = TABLES + NW * SCRATCH;  // the rows' index in smem
  const int scratch = TABLES + (threadIdx.x >> 5) * SCRATCH;
  const Lane c = lane_consts(smem);
  const int n_st = prog[H_STAGES];
  const int* starts = prog + H_STAGE0;
  const int* jobs = starts + n_st + 1;
  for (int st = 0; st < n_st; ++st) {
    const int end = starts[st + 1];
    for (int j = starts[st] + (threadIdx.x >> 5); j < end; j += NW) {
      run_job(prog, jobs + j * JOB_WORDS, smem, rows, scratch, c);
    }
    __syncthreads();
  }
}

// Limb i of the program's output o, over the rows at `arena`.
__device__ __forceinline__ int out_value(const int* prog, const int* arena, int o, int i) {
  const int* outs = prog + H_STAGE0 + prog[H_STAGES] + 1 + prog[H_JOBS] * JOB_WORDS;
  const int* t = prog + outs[o * OUT_WORDS];
  const int n = outs[o * OUT_WORDS + 1];
  unsigned s = 0;
  for (int k = 0; k < n; ++k) {
    const int w = t[k];
    s += (unsigned)(((w & 0xFF) ^ 0x80) - 0x80) * (unsigned)arena[(w >> 8) * W + i];
  }
  return (int)s;
}

// Limb i of the program's output o (the block's rows).
__device__ __forceinline__ int out_limb(const int* prog, const int* smem, int nw,
                                        int o, int i) {
  return out_value(prog, smem + TABLES + nw * SCRATCH, o, i);
}

// ------------------------------------------------ one warp per lane element
// A one-job program (the standalone `mul`) leaves a block of warps per
// lane element idle but for one warp, and the block's copy of the tables
// costs as much as the job. Laid out by warp (coop.py PER_WARP), a block
// of NW warps copies the tables once and takes NW lane elements at a
// time, one a warp: after the tables and the NW warp scratches come NW
// sets of rows, warp w's at `warp_rows`, and each warp runs every job of
// the program on its own rows, the same job code as above.

// Shared memory of such a block: the tables, NW scratches, NW sets of rows.
__host__ __device__ constexpr int warp_smem_ints(int nw, int rows) {
  return TABLES + nw * (SCRATCH + rows * W);
}

// The index in smem of warp w's rows.
__host__ __device__ constexpr int warp_rows(int nw, int rows, int w) {
  return TABLES + nw * SCRATCH + w * rows * W;
}

// Run every stage of `prog` on the calling warp alone, over the rows at
// index `rows` of smem, with the warp's scratch at index `scratch`; the
// lane constants `c` from the block's tables.
__device__ __forceinline__ void run_warp(const int* prog, int* smem, int rows, int scratch,
                                         const Lane& c) {
  const int n_st = prog[H_STAGES];
  const int* starts = prog + H_STAGE0;
  const int* jobs = starts + n_st + 1;
  for (int st = 0; st < n_st; ++st) {
    const int end = starts[st + 1];
    for (int j = starts[st]; j < end; ++j) {
      run_job(prog, jobs + j * JOB_WORDS, smem, rows, scratch, c);
    }
    __syncwarp();  // the stage's rows, for the next stage's lanes
  }
}

// ------------------------------------------------ the group kernels' rows
// A point is 3 coordinates (X, Y, Z) of C rows each, in global memory as
// three [K, C, W, S] batches. The group kernels (jac_dbl.cu, jac_add.cu,
// chains.cu, ladder.cu) make their plain bodies' selects around the program: one
// block is one lane element, so a structural-infinity or digit test is
// uniform over the block and only picks the rows the block writes.

// Point (x, y, z) of lane element (k, s) into the rows from `rows`.
template <int NW, int C>
__device__ __forceinline__ void load_point(int* rows, const int* __restrict__ x,
                                           const int* __restrict__ y,
                                           const int* __restrict__ z, long k, long s, int S) {
  load<NW>(rows, x, C, k, s, S);
  load<NW>(rows + C * W, y, C, k, s, S);
  load<NW>(rows + 2 * C * W, z, C, k, s, S);
}

// Structural infinity (`_is_zero`: every limb exactly 0) of the n rows
// from `rows`, read before the program may reuse them. All threads of the
// block; a block barrier.
template <int NW>
__device__ __forceinline__ bool rows_zero(const int* rows, int n) {
  int nz = 0;
  for (int t = threadIdx.x; t < n * W; t += NW * 32) nz |= rows[t];
  return !__syncthreads_or(nz);
}

// ... and of the program's outputs o .. o + n - 1, after it.
template <int NW>
__device__ __forceinline__ bool outs_zero(const int* prog, const int* smem, int o, int n) {
  int nz = 0;
  for (int t = threadIdx.x; t < n * W; t += NW * 32) {
    nz |= out_limb(prog, smem, NW, o + t / W, t % W);
  }
  return !__syncthreads_or(nz);
}

// The point of lane element (k, s) into (ox, oy, oz): where `zero`
// (uniform over the block, as `copy`), infinity (every limb 0); where
// `copy`, the same rows of (sx, sy, sz) in global memory, else the
// program's outputs first .. first + 3 C - 1. Constant pointer picks: a
// dynamic index into an array of pointers would put it on the stack.
template <int NW, int C>
__device__ __forceinline__ void store_point(const int* prog, const int* smem, int first,
                                            bool copy, const int* sx, const int* sy,
                                            const int* sz, int* ox, int* oy, int* oz,
                                            long k, long s, int S, bool zero = false) {
  for (int t = threadIdx.x; t < 3 * C * W; t += NW * 32) {
    const int o = t / W, i = t - o * W, c = o / C;  // coordinate c, component o % C
    const long a = at(C, o % C, i, k, s, S);
    (c == 0 ? ox : (c == 1 ? oy : oz))[a] =
        zero ? 0
             : (copy ? (c == 0 ? sx : (c == 1 ? sy : sz))[a]
                     : out_limb(prog, smem, NW, first + o, i));
  }
}

}  // namespace coop
}  // namespace lh
