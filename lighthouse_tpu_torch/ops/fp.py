"""Constants and host codecs of the lane-major Fp core (no device code).

The port's own recomputation of the number theory in the reference's
lighthouse_tpu/ops/fp.py:56-134, from Python ints and numpy only: an Fp
element is W = 36 signed lazy limbs of B = 11 bits (396-bit capacity),
value = sum(limb[i] << (11*i)) mod p; a limb product is reduced by folding
the limbs of weight >= 2^(11*35) down through constant matrices.
tests/test_torch_fp.py pins every table here equal to the reference's.
"""

import numpy as np

from ..crypto.bls.params import P

B = 11                       # bits per limb
W = 36                       # working limbs (396-bit capacity)
MASK = (1 << B) - 1
CONVW = 2 * W + 1            # conv output width incl. carry headroom (73)
FOLD_AT = 35                 # fold everything with weight >= 2^(11*35)

# ---------------------------------------------------------------- host codecs


def to_limbs(x: int, width: int = W) -> np.ndarray:
    """Python int (any sign) -> canonical limb vector of x mod p."""
    x = x % P
    out = np.zeros(width, dtype=np.int32)
    for i in range(width):
        out[i] = x & MASK
        x >>= B
    if x:
        raise ValueError("value exceeds limb capacity")
    return out


def from_limbs(v) -> int:
    """Limb vector (any lazy/signed form, any width) -> int mod p."""
    v = np.asarray(v)
    acc = 0
    for i in reversed(range(v.shape[-1])):
        acc = (acc << B) + int(v[..., i])
    return acc % P


def _limbs_raw(x: int, width: int) -> np.ndarray:
    return np.array([(x >> (B * i)) & MASK for i in range(width)], dtype=np.int32)


# Fold matrices: row i = limbs of (2^(11*(FOLD_AT+i)) mod p). Entries < 2^11.
def _fold_matrix(n_hi: int) -> np.ndarray:
    return np.stack(
        [to_limbs(pow(2, B * (FOLD_AT + i), P)) for i in range(n_hi)]
    ).astype(np.int32)


FOLD_FULL = _fold_matrix(CONVW - FOLD_AT)   # [38, 36]
FOLD_2 = _fold_matrix(2)                    # [2, 36]
FOLD_1 = _fold_matrix(1)                    # [1, 36]

ZERO = np.zeros(W, dtype=np.int32)
ONE = to_limbs(1)

# canonical(): K*p >= 2^386 offset, and the p*2^k subtract ladder (37 limbs)
_KP = ((1 << 386) // P + 1) * P
KP_37 = _limbs_raw(_KP, 37)
_LADDER_ROUNDS = 7                           # covers values < p * 2^7
PK_LADDER = np.stack([_limbs_raw(P << k, 37) for k in range(_LADDER_ROUNDS)])


def _topfold(width: int) -> np.ndarray:
    """limbs(2^(B*width) mod p) at `width`: re-absorbs the top limb's
    carry-out instead of dropping it (the top carry of a NEGATIVE lazy
    value is -1). Entries canonical (< 2^11, limbs above 35 zero)."""
    return _limbs_raw(pow(2, B * width, P), width)
