// K2: `canon_reduce`, canonical()'s pre-ripple reduction, and `norm3`, the
// Fp core's public carry reset.
//
// Replace the reference's Pallas kernels `canon_reduce`
// (lighthouse_tpu/ops/lane/fp.py `_canon_reduce_fn` -> `_canon_reduce_body`)
// and `norm3` (fp.py:443, `_norm3_fn`: the `norm3.kernel` site, 2 carry
// passes with the top carry folded back mod p).
//
// Bound on the H100: memory bytes and launch latency. Per element
// canon_reduce reads and writes 144 bytes and does 4 single-row folds (144
// multiply-adds) and 2 open carry passes, about 2 int32 operations per
// byte; norm3 does 2 carry passes (360 operations) on the same 288 bytes.
// Both are under the card's balance. Design: one thread per lane element,
// limbs in registers, the fold row and topfold vector in constant memory,
// coalesced loads and stores.
#include "fp_lane.cuh"

namespace {

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
    k_norm3(const int* __restrict__ x, int* __restrict__ out, int K, int S) {
  long base;
  if (!lh::elem_index(K, S, &base)) return;
  int v[lh::W];
  lh::load_elem(v, x, base, S);
  lh::norm<lh::W, lh::NORM3_KERNEL>(v);
  lh::store_elem(out, v, base, S);
}

}  // namespace

LH_EXPORT int lh_fp_canon_init(const void* folds, const void* topfm) {
  return lh::copy_consts(folds, topfm);
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

LH_EXPORT int lh_fp_norm3(const void* x, void* out, int K, int S,
                          void* stream) {
  k_norm3<<<lh::blocks_for(K, S), lh::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)x, (int*)out, K, S);
  return (int)cudaGetLastError();
}
