// K5-K9: the tower kernels `reduce_light`, `f2mul`, `f2sqr`, `f6mul`,
// `f12mul`, `f12sqr` and `f12mul_034`, one entry each.
//
// Replace the reference's Pallas kernels `reduce_light`
// (lighthouse_tpu/ops/lane/fp.py:442, `_reduce_light_body`) and `f2mul`,
// `f2sqr`, `f6mul`, `f12mul`, `f12sqr`, `f12mul_034`
// (lighthouse_tpu/ops/lane/tower.py:217-222, `_f2mul_body` / `_f2sqr_body`
// / `_f6mul_body` / `_f12mul_body` / `_f12sqr_body` / `_f12mul_034_body`).
// The last two are the unfused halves of the Miller doubling: their bodies
// also run inside k_miller_dbl_iter and k_miller_add_iter (miller.cu),
// as those kernels' programs.
//
// Bound on the H100: integer operations. Per lane element f12mul does 54
// Fp products (~390,000 int32 operations) against 3 x 1,728 bytes in and
// out; f12sqr 36 products against 2 x 1,728 bytes, f12mul_034 39 against
// 1,728 + 3 x 288 + 1,728; f2mul and f6mul the same ratio at 3 and 18
// products. reduce_light (two single-row folds, ~300 operations on 288
// bytes) is bound by bytes, and at a verify's widths (2 x 2,048 and 6 x
// 1 lane elements) by launch latency.
//
// Every kernel here but `reduce_light` is cooperative (coop.cuh): a block
// of NW warps per lane element (F12MUL_WARPS, F6MUL_WARPS, F2MUL_WARPS,
// F2SQR_WARPS, F12SQR_WARPS, F12MUL_034_WARPS), the element's rows in
// shared memory, each Fp product or reduce_light one warp's job. Their
// programs are traced by ops/lane/coop.py. `f6mul`'s, from `_f6mul_body`,
// is 3 stages: the 18 products of its six Karatsuba f2muls side by side,
// then their 12 reduce_lights, then the output's 6, on 30 rows. All its
// launches (4 a BLS verify, 4 a KZG pairing check: the final
// exponentiation's Fp12 inversion, two f6sqr and two products) run at one
// lane element. `f12mul`'s, from `_f12mul_body`, is 3 stages: the 54
// products of the three Fp6 Karatsuba products side by side, then the
// f2mul and the f6mul reduce_lights (36, 18), on 90 rows. 36 of its 46
// launches a BLS verify run at one lane (the final exponentiation).
// `f2mul`'s, from `_f2mul_body`, is 2 stages: the three Karatsuba products
// side by side, then the two reduce_lights, on 7 rows; its 183 launches a
// bucket-1024 verify run at 1 to 4 x 2,048 lane elements. `f2sqr`'s, from
// `_f2sqr_body`, is one stage of two products, (a0 + a1)(a0 - a1) and
// a0 (a1 + a1), on 4 rows; its 51 launches a bucket-1024 verify outside
// the ratio chain run at 1 to 4 x 2,048 lane elements. `f12sqr`'s, from
// `_f12sqr_body`, is 3 stages: the 36 products of its two Fp6 products
// (a0 + a1)(a0 + v a1) and a0 a1 side by side, then their 24 and 12
// reduce_lights, on 60 rows. `f12mul_034`'s, from `_f12mul_034_body`, is
// 2 stages: the 39 products of its thirteen f2muls by the line's
// coefficients side by side, then their 26 reduce_lights, on 65 rows.
// The last two run only on the unfused Miller doubling
// (f12mul_034(f12sqr(f), ...), 63 launches each at 128 lanes in
// chip_smoke.py's phase 7).
//
// `reduce_light` keeps one thread per lane element, its limbs in
// registers (fp_lane.cuh `reduce_light_body`), FOLDS column 40 and TOPFM's
// row read from the block's copy in shared memory, not the constant bank.
// No one-thread Fp2, Fp6 or Fp12 code is left here.
#include "coop.cuh"
#include "coop_programs.h"
#include "fp_lane.cuh"

namespace {

using lh::W;

__global__ void __launch_bounds__(lh::THREADS)
    k_reduce_light(const int* __restrict__ a, int* __restrict__ out, int K, int S) {
  const volatile int* tab = lh::block_tables<lh::T_F40, lh::T_WORDS>();
  long base;
  if (!lh::elem_index(K, S, &base)) return;
  int x[W];
  lh::load_elem(x, a, base, S);
  lh::reduce_light_body(x, tab, tab + (lh::T_TF - lh::T_F40));
  lh::store_elem(out, x, base, S);
}

// ------------------------------------------------------------ cooperative

// warps per lane element, from ops/lane/coop.py PROGRAMS
constexpr int F12MUL_NW = lh::coop::F12MUL_WARPS;
constexpr int F2MUL_NW = lh::coop::F2MUL_WARPS;
constexpr int F2SQR_NW = lh::coop::F2SQR_WARPS;
constexpr int F6MUL_NW = lh::coop::F6MUL_WARPS;
constexpr int F12SQR_NW = lh::coop::F12SQR_WARPS;
constexpr int F12MUL_034_NW = lh::coop::F12MUL_034_WARPS;
static_assert(lh::coop::F12MUL_INS == 24 && lh::coop::F12MUL_OUTS == 12, "f12mul: a, b -> a b");
static_assert(lh::coop::F6MUL_INS == 12 && lh::coop::F6MUL_OUTS == 6, "f6mul: a, b -> a b");
static_assert(lh::coop::F2MUL_INS == 4 && lh::coop::F2MUL_OUTS == 2, "f2mul: a, b -> a b");
static_assert(lh::coop::F2SQR_INS == 2 && lh::coop::F2SQR_OUTS == 2, "f2sqr: a -> a^2");
static_assert(lh::coop::F12SQR_INS == 12 && lh::coop::F12SQR_OUTS == 12, "f12sqr: a -> a^2");
static_assert(lh::coop::F12MUL_034_INS == 18 && lh::coop::F12MUL_034_OUTS == 12,
              "f12mul_034: f, c0, c1, c4 -> f (c0 + c1 v + c4 v w)");
// the dynamic shared memory each block launches with
constexpr int F12MUL_SMEM = 4 * lh::coop::smem_ints(F12MUL_NW, lh::coop::F12MUL_ROWS);
constexpr int F2MUL_SMEM = 4 * lh::coop::smem_ints(F2MUL_NW, lh::coop::F2MUL_ROWS);
constexpr int F2SQR_SMEM = 4 * lh::coop::smem_ints(F2SQR_NW, lh::coop::F2SQR_ROWS);
constexpr int F6MUL_SMEM = 4 * lh::coop::smem_ints(F6MUL_NW, lh::coop::F6MUL_ROWS);
constexpr int F12SQR_SMEM = 4 * lh::coop::smem_ints(F12SQR_NW, lh::coop::F12SQR_ROWS);
constexpr int F12MUL_034_SMEM =
    4 * lh::coop::smem_ints(F12MUL_034_NW, lh::coop::F12MUL_034_ROWS);
static_assert(F12MUL_SMEM <= 227 * 1024 && F2MUL_SMEM <= 227 * 1024 &&
                  F2SQR_SMEM <= 227 * 1024 && F6MUL_SMEM <= 227 * 1024 &&
                  F12SQR_SMEM <= 227 * 1024 && F12MUL_034_SMEM <= 227 * 1024,
              "a block's shared memory");

__global__ void __launch_bounds__(F2MUL_NW * 32, lh::coop::min_blocks(F2MUL_NW))
    k_f2mul(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
            int S) {
  constexpr int NW = F2MUL_NW;
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  // the program's input rows: a (2), b (2)
  lh::coop::load<NW>(rows, a, 2, k, s, S);
  lh::coop::load<NW>(rows + 2 * W, b, 2, k, s, S);
  __syncthreads();
  lh::coop::run<NW>(lh::coop::c_prog_f2mul, smem);
  for (int t = threadIdx.x; t < 2 * W; t += NW * 32) {
    const int o = t / W, i = t - o * W;
    out[lh::coop::at(2, o, i, k, s, S)] =
        lh::coop::out_limb(lh::coop::c_prog_f2mul, smem, NW, o, i);
  }
}

__global__ void __launch_bounds__(F2SQR_NW * 32, lh::coop::min_blocks(F2SQR_NW))
    k_f2sqr(const int* __restrict__ a, int* __restrict__ out, int S) {
  constexpr int NW = F2SQR_NW;
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  // the program's input rows: a (2)
  lh::coop::load<NW>(rows, a, 2, k, s, S);
  __syncthreads();
  lh::coop::run<NW>(lh::coop::c_prog_f2sqr, smem);
  for (int t = threadIdx.x; t < 2 * W; t += NW * 32) {
    const int o = t / W, i = t - o * W;
    out[lh::coop::at(2, o, i, k, s, S)] =
        lh::coop::out_limb(lh::coop::c_prog_f2sqr, smem, NW, o, i);
  }
}

__global__ void __launch_bounds__(F6MUL_NW * 32, lh::coop::min_blocks(F6MUL_NW))
    k_f6mul(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
            int S) {
  constexpr int NW = F6MUL_NW;
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  // the program's input rows: a (6), b (6)
  lh::coop::load<NW>(rows, a, 6, k, s, S);
  lh::coop::load<NW>(rows + 6 * W, b, 6, k, s, S);
  __syncthreads();
  lh::coop::run<NW>(lh::coop::c_prog_f6mul, smem);
  for (int t = threadIdx.x; t < 6 * W; t += NW * 32) {
    const int o = t / W, i = t - o * W;
    out[lh::coop::at(6, o, i, k, s, S)] =
        lh::coop::out_limb(lh::coop::c_prog_f6mul, smem, NW, o, i);
  }
}

__global__ void __launch_bounds__(F12MUL_NW * 32, lh::coop::min_blocks(F12MUL_NW))
    k_f12mul(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
             int S) {
  constexpr int NW = F12MUL_NW;
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  // the program's input rows: a (12), b (12)
  lh::coop::load<NW>(rows, a, 12, k, s, S);
  lh::coop::load<NW>(rows + 12 * W, b, 12, k, s, S);
  __syncthreads();
  lh::coop::run<NW>(lh::coop::c_prog_f12mul, smem);
  for (int t = threadIdx.x; t < 12 * W; t += NW * 32) {
    const int o = t / W, i = t - o * W;
    out[lh::coop::at(12, o, i, k, s, S)] =
        lh::coop::out_limb(lh::coop::c_prog_f12mul, smem, NW, o, i);
  }
}

__global__ void __launch_bounds__(F12SQR_NW * 32, lh::coop::min_blocks(F12SQR_NW))
    k_f12sqr(const int* __restrict__ a, int* __restrict__ out, int S) {
  constexpr int NW = F12SQR_NW;
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  // the program's input rows: a (12)
  lh::coop::load<NW>(rows, a, 12, k, s, S);
  __syncthreads();
  lh::coop::run<NW>(lh::coop::c_prog_f12sqr, smem);
  for (int t = threadIdx.x; t < 12 * W; t += NW * 32) {
    const int o = t / W, i = t - o * W;
    out[lh::coop::at(12, o, i, k, s, S)] =
        lh::coop::out_limb(lh::coop::c_prog_f12sqr, smem, NW, o, i);
  }
}

__global__ void __launch_bounds__(F12MUL_034_NW * 32, lh::coop::min_blocks(F12MUL_034_NW))
    k_f12mul_034(const int* __restrict__ f, const int* __restrict__ c0,
                 const int* __restrict__ c1, const int* __restrict__ c4,
                 int* __restrict__ out, int S) {
  constexpr int NW = F12MUL_034_NW;
  long k, s;
  lh::coop::block_elem(S, &k, &s);
  int* smem = lh::coop::dyn_smem();
  int* rows = lh::coop::setup<NW>(smem);
  // the program's input rows: f (12), c0 (2), c1 (2), c4 (2)
  lh::coop::load<NW>(rows, f, 12, k, s, S);
  lh::coop::load<NW>(rows + 12 * W, c0, 2, k, s, S);
  lh::coop::load<NW>(rows + 14 * W, c1, 2, k, s, S);
  lh::coop::load<NW>(rows + 16 * W, c4, 2, k, s, S);
  __syncthreads();
  lh::coop::run<NW>(lh::coop::c_prog_f12mul_034, smem);
  for (int t = threadIdx.x; t < 12 * W; t += NW * 32) {
    const int o = t / W, i = t - o * W;
    out[lh::coop::at(12, o, i, k, s, S)] =
        lh::coop::out_limb(lh::coop::c_prog_f12mul_034, smem, NW, o, i);
  }
}

}  // namespace

LH_EXPORT int lh_tower_init(const void* folds, const void* topfm) {
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = lh::coop::copy_tables(folds, topfm);
  if (!e) e = lh::copy_short_tables(folds, topfm, nullptr, nullptr);
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_f12mul, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  F12MUL_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_f2mul, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  F2MUL_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_f2sqr, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  F2SQR_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_f6mul, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  F6MUL_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_f12sqr, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  F12SQR_SMEM);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(k_f12mul_034, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  F12MUL_034_SMEM);
  }
  return e;
}

// The dynamic shared memory (bytes) a block of program `slot` (coop.py
// PROGRAMS: f12mul, f6mul, f2mul, f2sqr, f12sqr, f12mul_034) launches
// with; -1 for another slot.
LH_EXPORT int lh_tower_launch_smem(int slot) {
  if (slot == lh::coop::F12MUL_SLOT) return F12MUL_SMEM;
  if (slot == lh::coop::F6MUL_SLOT) return F6MUL_SMEM;
  if (slot == lh::coop::F2SQR_SLOT) return F2SQR_SMEM;
  if (slot == lh::coop::F12SQR_SLOT) return F12SQR_SMEM;
  if (slot == lh::coop::F12MUL_034_SLOT) return F12MUL_034_SMEM;
  return slot == lh::coop::F2MUL_SLOT ? F2MUL_SMEM : -1;
}

LH_EXPORT const char* lh_tower_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_fp_reduce_light(const void* a, void* out, int K, int S,
                                 void* stream) {
  k_reduce_light<<<lh::blocks_for(K, S), lh::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)a, (int*)out, K, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_f2mul(const void* a, const void* b, void* out, int K, int S,
                       void* stream) {
  k_f2mul<<<(unsigned)((long)K * S), F2MUL_NW * 32, F2MUL_SMEM, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (int*)out, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_f2sqr(const void* a, void* out, int K, int S, void* stream) {
  k_f2sqr<<<(unsigned)((long)K * S), F2SQR_NW * 32, F2SQR_SMEM, (cudaStream_t)stream>>>(
      (const int*)a, (int*)out, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_f6mul(const void* a, const void* b, void* out, int K, int S,
                       void* stream) {
  k_f6mul<<<(unsigned)((long)K * S), F6MUL_NW * 32, F6MUL_SMEM, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (int*)out, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_f12mul(const void* a, const void* b, void* out, int K, int S,
                        void* stream) {
  k_f12mul<<<(unsigned)((long)K * S), F12MUL_NW * 32, F12MUL_SMEM, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (int*)out, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_f12sqr(const void* a, void* out, int K, int S, void* stream) {
  k_f12sqr<<<(unsigned)((long)K * S), F12SQR_NW * 32, F12SQR_SMEM, (cudaStream_t)stream>>>(
      (const int*)a, (int*)out, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_f12mul_034(const void* f, const void* c0, const void* c1,
                            const void* c4, void* out, int K, int S,
                            void* stream) {
  k_f12mul_034<<<(unsigned)((long)K * S), F12MUL_034_NW * 32, F12MUL_034_SMEM,
                 (cudaStream_t)stream>>>((const int*)f, (const int*)c0, (const int*)c1,
                                         (const int*)c4, (int*)out, S);
  return (int)cudaGetLastError();
}
