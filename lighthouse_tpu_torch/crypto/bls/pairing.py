"""Pure-Python optimal-ate pairing on BLS12-381 (reference/oracle).

Deliberately the *generic* construction: G2 points are untwisted into
E(Fp12) and the Miller loop runs with full Fp12 affine arithmetic and true
field inversions. Slow but convention-proof — the optimized pipeline
(sparse lines, projective coords, cyclotomic final exp) is validated against
this module. The port's own copy of lighthouse_tpu/crypto/bls/pairing.py (see reference hot path crypto/bls/src/impls/blst.rs:114-116,
which delegates the same math to blst's verify_multiple_aggregate_signatures).
"""

from . import params
from .params import P, R
from . import fields as F

# w and its inverse powers, for the untwist E2(Fp2) -> E(Fp12).
_W = (F.F6_ZERO, F.F6_ONE)  # w: w^2 = v, v^3 = xi
_WINV = F.f12inv(_W)
_WINV2 = F.f12mul(_WINV, _WINV)
_WINV3 = F.f12mul(_WINV2, _WINV)


def _emb2(a):
    """Embed Fp2 element into Fp12 (c0 slot of c0 slot)."""
    return ((a, F.F2_ZERO, F.F2_ZERO), F.F6_ZERO)


def _emb(a):
    """Embed Fp element into Fp12."""
    return _emb2((a, 0))


def untwist(q):
    """Map a point on the M-twist E2(Fp2) to E(Fp12): (x/w^2, y/w^3)."""
    if q is None:
        return None
    x, y = q
    return (F.f12mul(_emb2(x), _WINV2), F.f12mul(_emb2(y), _WINV3))


# Affine ops on E(Fp12): y^2 = x^3 + 4.
def _e12_double(pt):
    x, y = pt
    x2 = F.f12sqr(x)
    lam = F.f12mul(
        F.f12add(F.f12add(x2, x2), x2), F.f12inv(F.f12add(y, y))
    )
    x3 = F.f12sub(F.f12sqr(lam), F.f12add(x, x))
    y3 = F.f12sub(F.f12mul(lam, F.f12sub(x, x3)), y)
    return (x3, y3), lam


def _e12_add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    lam = F.f12mul(F.f12sub(y2, y1), F.f12inv(F.f12sub(x2, x1)))
    x3 = F.f12sub(F.f12sub(F.f12sqr(lam), x1), x2)
    y3 = F.f12sub(F.f12mul(lam, F.f12sub(x1, x3)), y1)
    return (x3, y3), lam


def _line_eval(t, lam, p12):
    """Evaluate the line through t with slope lam at p12 (all in Fp12)."""
    xt, yt = t
    xp, yp = p12
    return F.f12sub(F.f12sub(yp, yt), F.f12mul(lam, F.f12sub(xp, xt)))


def miller_loop(p_g1, q_g2):
    """f_{|X|, Q}(P) with the ate loop count |X|; inverted for X < 0.

    p_g1: affine G1 point (ints); q_g2: affine G2 point (Fp2 pairs).
    Returns an Fp12 element (before final exponentiation).
    """
    if p_g1 is None or q_g2 is None:
        return F.F12_ONE
    pp = (_emb(p_g1[0]), _emb(p_g1[1]))
    qq = untwist(q_g2)
    n = -params.X  # positive loop count (X < 0 for BLS12-381)
    bits = bin(n)[3:]  # skip the leading 1
    f = F.F12_ONE
    t = qq
    for b in bits:
        t2, lam = _e12_double(t)
        f = F.f12mul(F.f12sqr(f), _line_eval(t, lam, pp))
        t = t2
        if b == "1":
            t2, lam = _e12_add(t, qq)
            f = F.f12mul(f, _line_eval(t, lam, pp))
            t = t2
    # X is negative: f_{-n} = 1 / f_n (vertical lines cancel under final exp)
    return F.f12inv(f)


FINAL_EXP_POWER = (P**12 - 1) // R


def final_exponentiation(f):
    return F.f12pow(f, FINAL_EXP_POWER)


def pairing(p_g1, q_g2):
    """Full pairing e(P, Q) ∈ mu_r ⊂ Fp12."""
    return final_exponentiation(miller_loop(p_g1, q_g2))


def multi_pairing(pairs):
    """prod_i e(P_i, Q_i): shared final exponentiation over the product of
    Miller loops — the structure the batch verifier exploits
    (one final exp per verify_signature_sets batch)."""
    f = F.F12_ONE
    for p_g1, q_g2 in pairs:
        f = F.f12mul(f, miller_loop(p_g1, q_g2))
    return final_exponentiation(f)


def pairings_product_is_one(pairs):
    return multi_pairing(pairs) == F.F12_ONE
