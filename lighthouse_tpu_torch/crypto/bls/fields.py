"""Pure-Python BLS12-381 field tower: Fp, Fp2, Fp6, Fp12.

This module is the *reference/oracle* arithmetic: small, obviously-correct,
operating on Python ints and tuples. The port's own copy of
lighthouse_tpu/crypto/bls/fields.py (the port imports nothing of the JAX
package); the lane-major torch field core is validated against it.

Tower (standard):
    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = 1 + u
    Fp12 = Fp6[w] / (w^2 - v)

Representations:
    Fp   : int in [0, P)
    Fp2  : (c0, c1)            meaning c0 + c1*u
    Fp6  : (a0, a1, a2)        ai in Fp2, meaning a0 + a1*v + a2*v^2
    Fp12 : (b0, b1)            bi in Fp6, meaning b0 + b1*w
"""

from .params import P, XI

# ---------------------------------------------------------------- Fp

def fadd(a, b):
    return (a + b) % P


def fsub(a, b):
    return (a - b) % P


def fmul(a, b):
    return (a * b) % P


def finv(a):
    if a == 0:
        raise ZeroDivisionError("inverse of 0 in Fp")
    return pow(a, P - 2, P)


def fsqrt(a):
    """Square root in Fp (P % 4 == 3 so a^((P+1)/4) works). None if no root."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a else None


# ---------------------------------------------------------------- Fp2

F2_ZERO = (0, 0)
F2_ONE = (1, 0)


def f2add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2neg(a):
    return (-a[0] % P, -a[1] % P)


def f2mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2sqr(a):
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    t0 = (a[0] + a[1]) * (a[0] - a[1])
    t1 = 2 * a[0] * a[1]
    return (t0 % P, t1 % P)


def f2smul(a, k):
    """Multiply Fp2 element by Fp scalar."""
    return (a[0] * k % P, a[1] * k % P)


def f2conj(a):
    return (a[0], -a[1] % P)


def f2inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    inv = finv(norm)
    return (a[0] * inv % P, -a[1] * inv % P)


def f2mul_xi(a):
    """Multiply by xi = 1 + u: (a0 - a1) + (a0 + a1) u."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def f2pow(a, e):
    out = F2_ONE
    base = a
    while e:
        if e & 1:
            out = f2mul(out, base)
        base = f2sqr(base)
        e >>= 1
    return out


def f2sqrt(a):
    """Square root in Fp2, None if a is a non-residue.

    Uses the p % 4 == 3 algorithm (Adj–Rodríguez-Henríquez):
        a1 = a^((p-3)/4); x0 = a1 * a; alpha = a1 * x0
        if alpha == -1: root = i * x0
        else: root = (1 + alpha)^((p-1)/2) * x0
    """
    if a == F2_ZERO:
        return F2_ZERO
    a1 = f2pow(a, (P - 3) // 4)
    x0 = f2mul(a1, a)
    alpha = f2mul(a1, x0)
    if alpha == (P - 1, 0):
        root = (-x0[1] % P, x0[0])  # u * x0
    else:
        b = f2pow(f2add(F2_ONE, alpha), (P - 1) // 2)
        root = f2mul(b, x0)
    return root if f2sqr(root) == a else None


# ---------------------------------------------------------------- Fp6

F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6add(a, b):
    return (f2add(a[0], b[0]), f2add(a[1], b[1]), f2add(a[2], b[2]))


def f6sub(a, b):
    return (f2sub(a[0], b[0]), f2sub(a[1], b[1]), f2sub(a[2], b[2]))


def f6neg(a):
    return (f2neg(a[0]), f2neg(a[1]), f2neg(a[2]))


def f6mul(a, b):
    # Toom/Karatsuba-lite (standard v^3 = xi reduction)
    t0 = f2mul(a[0], b[0])
    t1 = f2mul(a[1], b[1])
    t2 = f2mul(a[2], b[2])
    c0 = f2add(t0, f2mul_xi(f2sub(f2mul(f2add(a[1], a[2]), f2add(b[1], b[2])), f2add(t1, t2))))
    c1 = f2add(f2sub(f2mul(f2add(a[0], a[1]), f2add(b[0], b[1])), f2add(t0, t1)), f2mul_xi(t2))
    c2 = f2add(f2sub(f2mul(f2add(a[0], a[2]), f2add(b[0], b[2])), f2add(t0, t2)), t1)
    return (c0, c1, c2)


def f6sqr(a):
    return f6mul(a, a)


def f6mul_by_v(a):
    """Multiply by v: (a0 + a1 v + a2 v^2) * v = xi*a2 + a0 v + a1 v^2."""
    return (f2mul_xi(a[2]), a[0], a[1])


def f6inv(a):
    # Standard formula via the norm to Fp2.
    c0 = f2sub(f2sqr(a[0]), f2mul_xi(f2mul(a[1], a[2])))
    c1 = f2sub(f2mul_xi(f2sqr(a[2])), f2mul(a[0], a[1]))
    c2 = f2sub(f2sqr(a[1]), f2mul(a[0], a[2]))
    t = f2add(f2mul(a[0], c0), f2mul_xi(f2add(f2mul(a[2], c1), f2mul(a[1], c2))))
    ti = f2inv(t)
    return (f2mul(c0, ti), f2mul(c1, ti), f2mul(c2, ti))


# ---------------------------------------------------------------- Fp12

F12_ZERO = (F6_ZERO, F6_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)


def f12add(a, b):
    return (f6add(a[0], b[0]), f6add(a[1], b[1]))


def f12sub(a, b):
    return (f6sub(a[0], b[0]), f6sub(a[1], b[1]))


def f12mul(a, b):
    t0 = f6mul(a[0], b[0])
    t1 = f6mul(a[1], b[1])
    c0 = f6add(t0, f6mul_by_v(t1))
    c1 = f6sub(f6sub(f6mul(f6add(a[0], a[1]), f6add(b[0], b[1])), t0), t1)
    return (c0, c1)


def f12sqr(a):
    return f12mul(a, a)


def f12conj(a):
    """Conjugation = Frobenius^6: a0 - a1 w."""
    return (a[0], f6neg(a[1]))


def f12inv(a):
    t = f6sub(f6sqr(a[0]), f6mul_by_v(f6sqr(a[1])))
    ti = f6inv(t)
    return (f6mul(a[0], ti), f6neg(f6mul(a[1], ti)))


def f12pow(a, e):
    if e < 0:
        return f12pow(f12inv(a), -e)
    out = F12_ONE
    base = a
    while e:
        if e & 1:
            out = f12mul(out, base)
        base = f12sqr(base)
        e >>= 1
    return out


# ------------------------------------------------- Frobenius on Fp2/Fp12

# frobenius on Fp2 is conjugation (since u^p = -u for p % 4 == 3).

# gamma constants for the psi endomorphism on the twist, computed at import
# (no magic constants): psi(x, y) = (PSI_CX * x^p, PSI_CY * y^p) maps the
# twist E2 to itself composed with untwist-frobenius-twist.
def _compute_psi_constants():
    # 1 / xi^((p-1)/3) and 1 / xi^((p-1)/2) in Fp2
    cx = f2inv(f2pow(XI, (P - 1) // 3))
    cy = f2inv(f2pow(XI, (P - 1) // 2))
    return cx, cy


PSI_CX, PSI_CY = _compute_psi_constants()
