"""Pure-Python BLS12-381 group operations: G1 (over Fp) and G2 (over Fp2).

Reference/oracle implementation (the port's own copy of
lighthouse_tpu/crypto/bls/curve.py). Points are affine: ``None`` is the point at
infinity, otherwise ``(x, y)`` with coordinates in the base field (int for G1,
(c0, c1) tuples for G2).

Serialization follows the ZCash/Ethereum compressed format the reference
consumes on the wire (48-byte G1 / 96-byte G2, flag bits in the top byte),
mirroring what blst implements for crypto/bls/src/impls/blst.rs.
"""

from . import params
from .params import P, R, B
from . import fields as F


# ---------------------------------------------------------------- generic ops

def _make_ops(add, sub, mul, sqr, inv, neg, zero, one, b_coeff):
    """Build affine curve ops for y^2 = x^3 + b over a generic field."""

    def on_curve(pt):
        if pt is None:
            return True
        x, y = pt
        return sqr(y) == add(mul(sqr(x), x), b_coeff)

    def pt_neg(pt):
        if pt is None:
            return None
        return (pt[0], neg(pt[1]))

    def pt_double(pt):
        if pt is None:
            return None
        x, y = pt
        if y == zero:
            return None
        lam = mul(add(sqr(x), add(sqr(x), sqr(x))), inv(add(y, y)))  # 3x^2 / 2y
        x3 = sub(sqr(lam), add(x, x))
        y3 = sub(mul(lam, sub(x, x3)), y)
        return (x3, y3)

    def pt_add(p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if y1 == y2:
                return pt_double(p1)
            return None
        lam = mul(sub(y2, y1), inv(sub(x2, x1)))
        x3 = sub(sub(sqr(lam), x1), x2)
        y3 = sub(mul(lam, sub(x1, x3)), y1)
        return (x3, y3)

    # Scalar ladders run in Jacobian coordinates internally: affine
    # add/double pay a field inversion PER STEP (Fermat pow — the
    # dominant cost in profiles), Jacobian pays ONE at the end.

    def _jac_double(p):
        if p is None:
            return None
        X, Y, Z = p
        A = sqr(X)
        Bv = sqr(Y)
        Cv = sqr(Bv)
        D = sub(sub(sqr(add(X, Bv)), A), Cv)
        D = add(D, D)
        E = add(add(A, A), A)
        Fv = sqr(E)
        X3 = sub(Fv, add(D, D))
        c8 = add(Cv, Cv)
        c8 = add(c8, c8)
        c8 = add(c8, c8)
        Y3 = sub(mul(E, sub(D, X3)), c8)
        Z3 = mul(add(Y, Y), Z)
        return (X3, Y3, Z3)

    def _jac_add(p, q):
        if p is None:
            return q
        if q is None:
            return p
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1 = sqr(Z1)
        Z2Z2 = sqr(Z2)
        U1 = mul(X1, Z2Z2)
        U2 = mul(X2, Z1Z1)
        S1 = mul(mul(Y1, Z2), Z2Z2)
        S2 = mul(mul(Y2, Z1), Z1Z1)
        if U1 == U2:
            if S1 == S2:
                return _jac_double(p)
            return None
        H = sub(U2, U1)
        I = sqr(add(H, H))
        J = mul(H, I)
        r2 = sub(S2, S1)
        rr = add(r2, r2)
        V = mul(U1, I)
        X3 = sub(sub(sqr(rr), J), add(V, V))
        SJ = mul(S1, J)
        Y3 = sub(mul(rr, sub(V, X3)), add(SJ, SJ))
        Z3 = mul(sub(sub(sqr(add(Z1, Z2)), Z1Z1), Z2Z2), H)
        return (X3, Y3, Z3)

    def _jac_from_affine(pt):
        return None if pt is None else (pt[0], pt[1], one)

    def _jac_to_affine(p):
        if p is None or p[2] == zero:
            return None
        X, Y, Z = p
        zi = inv(Z)
        zi2 = sqr(zi)
        return (mul(X, zi2), mul(mul(Y, zi2), zi))

    def _ladder(pt, k):
        out = None
        acc = _jac_from_affine(pt)
        while k:
            if k & 1:
                out = _jac_add(out, acc)
            acc = _jac_double(acc)
            k >>= 1
        return _jac_to_affine(out)

    def pt_mul(pt, k):
        k = k % R
        return _ladder(pt, k)

    def pt_mul_raw(pt, k):
        """Scalar mul WITHOUT reducing k mod R (for cofactor clearing)."""
        if k < 0:
            return pt_mul_raw(pt_neg(pt), -k)
        return _ladder(pt, k)

    return on_curve, pt_neg, pt_double, pt_add, pt_mul, pt_mul_raw


(g1_on_curve, g1_neg, g1_double, g1_add, g1_mul, g1_mul_raw) = _make_ops(
    F.fadd, F.fsub, F.fmul, lambda a: a * a % P, F.finv, lambda a: -a % P, 0, 1, B
)

_B2 = F.f2smul(params.XI, B)  # 4*(1+u)
(g2_on_curve, g2_neg, g2_double, g2_add, g2_mul, g2_mul_raw) = _make_ops(
    F.f2add, F.f2sub, F.f2mul, F.f2sqr, F.f2inv, F.f2neg, F.F2_ZERO, F.F2_ONE, _B2
)

G1_GEN = (params.G1X, params.G1Y)
G2_GEN = (params.G2X, params.G2Y)


# ---------------------------------------------------------------- endomorphisms

def psi(pt):
    """The psi endomorphism on the twist: untwist ∘ frobenius ∘ twist.

    psi(x, y) = (cx * x̄, cy * ȳ) with the constants computed in fields.py.
    Satisfies psi(P) == [X] P for P in G2 (used for fast subgroup checks and
    Budroni–Pintore cofactor clearing).
    """
    if pt is None:
        return None
    x, y = pt
    return (F.f2mul(F.PSI_CX, F.f2conj(x)), F.f2mul(F.PSI_CY, F.f2conj(y)))


def g2_subgroup_check(pt):
    """P ∈ G2 iff psi(P) == [X]P (Scott's fast check)."""
    if pt is None:
        return True
    if not g2_on_curve(pt):
        return False
    return psi(pt) == g2_mul_raw(pt, params.X % R) if params.X >= 0 else (
        psi(pt) == g2_neg(g2_mul_raw(pt, -params.X))
    )


def g1_subgroup_check(pt):
    """Reference check: [R]P == infinity."""
    if pt is None:
        return True
    if not g1_on_curve(pt):
        return False
    return g1_mul_raw(pt, R) is None


def g2_clear_cofactor(pt):
    """Budroni–Pintore fast cofactor clearing:

    h_eff · P ≡ [X^2 - X - 1]P + [X - 1]psi(P) + psi(psi(2P))   (mod G2)
    """
    x = params.X
    t0 = g2_mul_raw(pt, -(x * x - x - 1)) if (x * x - x - 1) < 0 else g2_mul_raw(pt, x * x - x - 1)
    t1 = g2_mul_raw(psi(pt), x - 1) if (x - 1) >= 0 else g2_neg(g2_mul_raw(psi(pt), -(x - 1)))
    t2 = psi(psi(g2_double(pt)))
    return g2_add(g2_add(t0, t1), t2)


# ---------------------------------------------------------------- serialization
# ZCash-style compressed encoding (what Ethereum consensus uses on the wire).

_SIGN_THRESHOLD = (P - 1) // 2


def _flags(compressed, infinity, sign):
    return (compressed << 7) | (infinity << 6) | (sign << 5)


def g1_compress(pt):
    if pt is None:
        return bytes([_flags(1, 1, 0)]) + b"\x00" * 47
    x, y = pt
    sign = 1 if y > _SIGN_THRESHOLD else 0
    raw = x.to_bytes(48, "big")
    return bytes([raw[0] | _flags(1, 0, sign)]) + raw[1:]


def g1_decompress(data, subgroup_check=True):
    """Decompress 48 bytes → G1 point. Raises ValueError on invalid encoding."""
    if len(data) != 48:
        raise ValueError("G1 compressed encoding must be 48 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G1 not supported on this codec")
    infinity, sign = (flags >> 6) & 1, (flags >> 5) & 1
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if infinity:
        if x != 0 or sign:
            raise ValueError("malformed infinity encoding")
        return None
    if x >= P:
        raise ValueError("x out of range")
    y = F.fsqrt((x * x % P * x + B) % P)
    if y is None:
        raise ValueError("x not on curve")
    if (1 if y > _SIGN_THRESHOLD else 0) != sign:
        y = P - y
    pt = (x, y)
    if subgroup_check and not g1_subgroup_check(pt):
        raise ValueError("point not in G1 subgroup")
    return pt


def g2_compress(pt):
    if pt is None:
        return bytes([_flags(1, 1, 0)]) + b"\x00" * 95
    (x0, x1), (y0, y1) = pt
    # lexicographic sign on y: compare (y1, y0)
    sign = 1 if (y1 > _SIGN_THRESHOLD or (y1 == 0 and y0 > _SIGN_THRESHOLD)) else 0
    raw = x1.to_bytes(48, "big") + x0.to_bytes(48, "big")
    return bytes([raw[0] | _flags(1, 0, sign)]) + raw[1:]


def g2_decompress(data, subgroup_check=True):
    if len(data) != 96:
        raise ValueError("G2 compressed encoding must be 96 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G2 not supported on this codec")
    infinity, sign = (flags >> 6) & 1, (flags >> 5) & 1
    x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if infinity:
        if x0 or x1 or sign:
            raise ValueError("malformed infinity encoding")
        return None
    if x0 >= P or x1 >= P:
        raise ValueError("x out of range")
    x = (x0, x1)
    rhs = F.f2add(F.f2mul(F.f2sqr(x), x), _B2)
    y = F.f2sqrt(rhs)
    if y is None:
        raise ValueError("x not on curve")
    y0, y1 = y
    got_sign = 1 if (y1 > _SIGN_THRESHOLD or (y1 == 0 and y0 > _SIGN_THRESHOLD)) else 0
    if got_sign != sign:
        y = F.f2neg(y)
    pt = (x, y)
    if subgroup_check and not g2_subgroup_check(pt):
        raise ValueError("point not in G2 subgroup")
    return pt
