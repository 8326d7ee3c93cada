// canonical() of one lane element in one thread: the value of
// ops/lane/fp.py `_canonical_fn`, for csrc/fp_canon.cu (`canonical`, one
// thread per lane element) and csrc/jac_add.cu (`add_exact_f1`'s zero
// tests of H and R, one thread each in the block's epilogue).
//
// `canon_reduce_body` (fp_lane.cuh), the pad to 37 limbs, + KP and an
// exact carry ripple (`_ripple_carry`), then the reduction by p * 2^k for
// k = 6 .. 0. Each caller passes the tables: KP [37], PK_LADDER [7, 37]
// (row k: p * 2^k) and FOLDS column 40, from its block's shared memory
// (`canonical` the column packed, `add_exact_f1` within all of FOLDS).
//
// The ladder comes in two forms, one a caller, with the same limbs out:
//
// - `Ladder::kRestoring` (`canonical`), the plain body's own: each round
//   ripples v - p * 2^k beside v and keeps it where the borrow out of its
//   top limb is >= 0; 8 ripples, unrolled. It holds 74 limbs in
//   registers, which a thread of `canonical` has.
// - `Ladder::kSigned` (`add_exact_f1`), non-restoring, in place: a round
//   subtracts p * 2^k where the value is >= 0 and adds it where it is <
//   0, the sign read off that round's carry out; a last round adds p
//   where the value is < 0. On the certified window (`canonical.ripple`:
//   v + KP in (0, p * 2^7)) the value after round k lies in [-p * 2^k,
//   p * 2^k), so the result is the representative in [0, p), rippled. It
//   holds 37 limbs, and its rounds are rolled, each row read where its
//   round runs: the cooperative kernel's thread has 64 registers and
//   spills the unrolled form. It costs 9 ripples against 8.
//
// Signed arithmetic as the plain body's: `>>` on int is arithmetic and
// `& MASK` takes the two's-complement low bits, as torch's and jnp's
// shifts and masks do. No sum wraps on the window.
#pragma once

#include "fp_lane.cuh"

namespace lh {

enum class Ladder { kRestoring, kSigned };

// `_ripple_carry` in place: s = limb + carry, carry = s >> B, limb = s &
// MASK, from limb 0 up; returns the carry out of the top limb.
__device__ __forceinline__ int ripple(int* v) {
  int carry = 0;
#pragma unroll
  for (int i = 0; i < W37; ++i) {
    const int s = v[i] + carry;
    carry = s >> B;
    v[i] = s & MASK;
  }
  return carry;
}

// canonical() in place: v[0 .. W) the lazy input, v[W] scratch; on return
// v[0 .. W) the canonical limbs (and v[W] 0). `kp` KP [37], `ladder`
// PK_LADDER [7, 37], `f40` FOLDS column 40 (f40[i * F40_STRIDE]); volatile
// pointers into shared memory, which read each entry where it is used (a
// cached copy of the folds' 36 entries would sit in registers beside the
// 37 limbs).
//
// kSigned, the limbs as the value: L = T mod 2^(37 B) for the signed
// value T. A subtract from T >= 0 carries -1 out exactly where T - p *
// 2^k < 0; an add to T < 0 (L = T + 2^(37 B)) carries +1 out exactly
// where T + p * 2^k >= 0: after the round T < 0 where carry - neg < 0.
template <Ladder L, int F40_STRIDE = NFOLD, class Tab>
__device__ __forceinline__ void canonical_body(int* v, Tab kp, Tab ladder, Tab f40) {
  canon_reduce_body<F40_STRIDE>(v, f40);
  v[W] = 0;
#pragma unroll
  for (int i = 0; i < W37; ++i) v[i] += kp[i];
  ripple(v);
  if constexpr (L == Ladder::kRestoring) {
#pragma unroll
    for (int k = LADDER_ROUNDS - 1; k >= 0; --k) {
      int d[W37];
#pragma unroll
      for (int i = 0; i < W37; ++i) d[i] = v[i] - ladder[k * W37 + i];
      const bool keep = ripple(d) >= 0;
#pragma unroll
      for (int i = 0; i < W37; ++i) v[i] = keep ? d[i] : v[i];
    }
  } else {
    int neg = 0;
#pragma unroll 1
    for (int k = LADDER_ROUNDS - 1; k >= 0; --k) {
      const Tab pk = ladder + k * W37;
      const int flip = neg - 1;  // -1: subtract p * 2^k, 0: add it
#pragma unroll
      for (int i = 0; i < W37; ++i) v[i] += (pk[i] ^ flip) - flip;
      neg = ripple(v) - neg < 0;
    }
    const int take = -neg;  // T in [-p, 0): + p
#pragma unroll
    for (int i = 0; i < W37; ++i) v[i] += ladder[i] & take;
    ripple(v);
  }
}

}  // namespace lh
