// K2: `canon_reduce`, canonical()'s pre-ripple reduction; `canonical`, the
// whole of canonical() in one kernel; and `norm3`, the Fp core's public
// carry reset.
//
// Replace the reference's Pallas kernels `canon_reduce`
// (lighthouse_tpu/ops/lane/fp.py `_canon_reduce_fn` -> `_canon_reduce_body`)
// and `norm3` (fp.py:443, `_norm3_fn`: the `norm3.kernel` site, 2 carry
// passes with the top carry folded back mod p). `canonical` runs
// `canon_reduce`'s body and then what the reference runs around that
// kernel as XLA glue (fp.py:490 `canonical`): the pad to 37 limbs, + KP and
// an exact carry ripple (`_ripple_carry`, fp.py:476, a lax.scan), then the
// subtract ladder, p * 2^k for k = 6 .. 0, each difference rippled and kept
// where the signed carry out of its top limb (the borrow) is >= 0. The
// paths call `canonical` only: `canon_reduce` stays the port of its Pallas
// kernel and is held on its own.
//
// Bound on the H100: memory bytes and launch latency. Per element each
// kernel reads and writes 144 bytes. canon_reduce does 4 single-row folds
// (144 multiply-adds) and 2 open carry passes, about 2 int32 operations
// per byte; norm3 2 carry passes (360 operations); canonical adds 8
// ripples of 37 limbs (add, shift, mask) and the ladder's 7 subtracts and
// selects, about 5 operations per byte. All are under the card's balance
// (10 int32 operations per byte). canonical's own floor is latency: each
// ripple is a chain of 37 dependent add-and-shift pairs, and each ladder
// round's ripple waits for the last round's select, so 8 x 37 x 2
// dependent operations a thread, after canon_reduce's 8.
//
// Design: one thread per lane element, limbs in registers, the ripples
// and the ladder csrc/canon.cuh's `canonical_body` in its restoring form
// (the plain body's; csrc/jac_add.cu's `add_exact_f1` runs its signed
// form). `canonical` reads KP, the ladder and FOLDS column 40, and
// `canon_reduce` FOLDS column 40, from the block's copy in shared memory
// (fp_lane.cuh `block_tables`), not the constant bank, where a miss on
// the chain stalls the warp at issue (column 40's entries lie 41 words
// apart, each on its own line of the bank): 0.0024 device ms at 4,096
// lanes against 0.0055 from the bank. `norm3` reads one TOPFM row, which
// the bank broadcasts, and keeps it there: at its path's 110,592 lanes it
// takes 0.0130 device ms with the L2 cleared before each launch, 1.37x
// its DRAM bytes bound of 0.0095 (0.0068 when its 16 MB input is still in
// the L2), and at 4,096 a launch's floor (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6). No path launches `canon_reduce`; `norm3` runs twice in the
// microbenchmark's lane baseline (tools/ubench_mul.py `lane_chain`, at its
// 110,592 lanes).
#include "canon.cuh"

namespace {

__global__ void __launch_bounds__(lh::THREADS)
    k_canon_reduce(const int* __restrict__ x, int* __restrict__ out, int K,
                   int S) {
  const volatile int* f40 = lh::block_tables<lh::T_F40, lh::T_TF>();
  long base;
  if (!lh::elem_index(K, S, &base)) return;
  int v[lh::W];
  lh::load_elem(v, x, base, S);
  lh::canon_reduce_body<1>(v, f40);
  lh::store_elem(out, v, base, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_canonical(const int* __restrict__ x, int* __restrict__ out, int K,
                int S) {
  const volatile int* tab = lh::block_tables<lh::T_KP, lh::T_TF>();
  long base;
  if (!lh::elem_index(K, S, &base)) return;
  int v[lh::W37];
  lh::load_elem(v, x, base, S);
  lh::canonical_body<lh::Ladder::kRestoring, 1>(v, tab + lh::T_KP, tab + lh::T_LADDER,
                                                tab + lh::T_F40);
  lh::store_elem(out, v, base, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_norm3(const int* __restrict__ x, int* __restrict__ out, int K, int S) {
  long base;
  if (!lh::elem_index(K, S, &base)) return;
  int v[lh::W];
  lh::load_elem(v, x, base, S);
  lh::norm<lh::W, lh::NORM3_KERNEL>(v);
  lh::store_elem(out, v, base, S);
}

}  // namespace

LH_EXPORT int lh_fp_canon_init(const void* folds, const void* topfm,
                               const void* kp37, const void* pk_ladder) {
  int e = lh::copy_consts(folds, topfm);
  if (!e) e = lh::copy_short_tables(folds, topfm, kp37, pk_ladder);
  return e;
}

LH_EXPORT const char* lh_fp_canon_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

LH_EXPORT int lh_fp_canon_reduce(const void* x, void* out, int K, int S,
                                 void* stream) {
  k_canon_reduce<<<lh::blocks_for(K, S), lh::THREADS, 0,
                   (cudaStream_t)stream>>>((const int*)x, (int*)out, K, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_fp_canonical(const void* x, void* out, int K, int S,
                              void* stream) {
  k_canonical<<<lh::blocks_for(K, S), lh::THREADS, 0,
                (cudaStream_t)stream>>>((const int*)x, (int*)out, K, S);
  return (int)cudaGetLastError();
}

LH_EXPORT int lh_fp_norm3(const void* x, void* out, int K, int S,
                          void* stream) {
  k_norm3<<<lh::blocks_for(K, S), lh::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)x, (int*)out, K, S);
  return (int)cudaGetLastError();
}
