"""CPU (pure-Python) BLS backend: the control implementation, the port's
copy of lighthouse_tpu/crypto/bls/backends/cpu.py over its own host
`curve`, `hash_to_curve` and `pairing_fast`.

The same random-linear-combination batch check as the device backend: per
set a nonzero 64-bit scalar r_i and the set's aggregate pubkey, then

    prod_i e([r_i] apk_i, H(m_i)) * e(-g1, sum_i [r_i] sig_i) == 1

with one shared final exponentiation. It is the verdict oracle the CUDA
backend (backends/cuda.py) is held to, and nothing else.
"""

from .. import curve as C
from .. import hash_to_curve as H2C
from .. import pairing_fast as PR
from .. import params


def verify_signature_sets(sets, rand_scalars) -> bool:
    """Batch-verify. Returns False on empty input, on a set with no keys
    and on an infinity signature or aggregate pubkey."""
    if not sets:
        return False
    if len(rand_scalars) != len(sets):
        raise ValueError("need one random scalar per set")
    pairs = []
    sig_acc = None
    for s, r in zip(sets, rand_scalars):
        if not s.signing_keys:
            return False
        if not (0 < r < 2**params.RAND_BITS):
            raise ValueError("batch scalar out of range")
        if s.signature.point is None:
            return False  # infinity signature
        apk = None
        for k in s.signing_keys:
            apk = C.g1_add(apk, k.point)
        if apk is None:
            return False
        pairs.append((C.g1_mul(apk, r), H2C.hash_to_g2(s.message)))
        sig_acc = C.g2_add(sig_acc, C.g2_mul(s.signature.point, r))
    pairs.append((C.g1_neg(C.G1_GEN), sig_acc))
    return PR.pairings_product_is_one_fast(pairs)


def verify_single(signature, pubkey, message: bytes) -> bool:
    """Plain (non-batch) verification: e(pk, H(m)) == e(g1, sig)."""
    if signature.point is None:
        return False
    pairs = [
        (pubkey.point, H2C.hash_to_g2(message)),
        (C.g1_neg(C.G1_GEN), signature.point),
    ]
    return PR.pairings_product_is_one_fast(pairs)
