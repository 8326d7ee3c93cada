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
// dependent operations a thread, after canon_reduce's 8. Design: one
// thread per lane element, limbs in registers, the fold row, the
// topfold vector, KP and the ladder in constant memory (every thread of a
// warp reads the same entry at once), coalesced loads and stores.
//
// The ripples and the ladder are csrc/canon.cuh's `canonical_body` in
// its restoring form (the plain body's); csrc/jac_add.cu's `add_exact_f1`
// runs its signed form, on its own copy of the tables.
#include "canon.cuh"

namespace {

// KP [37] and PK_LADDER [7, 37] (row k: p * 2^k), row-major int32, from
// ops/lane/fp.py through lh_fp_canon_init
static __constant__ __align__(16) int c_kp37[lh::W37];
static __constant__ __align__(16) int c_pk_ladder[lh::LADDER_ROUNDS * lh::W37];

__global__ void __launch_bounds__(lh::THREADS)
    k_canon_reduce(const int* __restrict__ x, int* __restrict__ out, int K,
                   int S) {
  long base;
  if (!lh::elem_index(K, S, &base)) return;
  int v[lh::W];
  lh::load_elem(v, x, base, S);
  lh::canon_reduce_body(v);
  lh::store_elem(out, v, base, S);
}

__global__ void __launch_bounds__(lh::THREADS)
    k_canonical(const int* __restrict__ x, int* __restrict__ out, int K,
                int S) {
  long base;
  if (!lh::elem_index(K, S, &base)) return;
  int v[lh::W37];
  lh::load_elem(v, x, base, S);
  lh::canonical_body<lh::Ladder::kRestoring, const int*>(v, c_kp37, c_pk_ladder, lh::c_folds + 40);
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
  if (!e) e = (int)cudaMemcpyToSymbol(c_kp37, kp37, sizeof(c_kp37));
  if (!e) e = (int)cudaMemcpyToSymbol(c_pk_ladder, pk_ladder, sizeof(c_pk_ladder));
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
