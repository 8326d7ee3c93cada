"""Optimized pairing on BLS12-381 — host prototype of the device pipeline.

The port's own copy of lighthouse_tpu/crypto/bls/pairing_fast.py; it
serves `Kzg`'s default host pairing seam.

Same math as pairing.py's generic oracle, restructured exactly the way
the reference's batched lane kernels (ops/lane/pairing.py) compute it:

- Miller loop over Jacobian twisted coordinates with *polynomial* line
  coefficients (denominators cleared by Fp2 factors, which the final
  exponentiation kills: any a in a proper subfield satisfies
  a^((p^2-1)*k) = 1 and (p^2-1) | (p^12-1)/r).
- Sparse line elements: l = c0 + c1*v + c4*v*w in the Fp12 basis
  w^(2i+j) (v = w^2, w^6 = xi).
- Final exponentiation: easy part f^((p^6-1)(p^2+1)), then the
  Hayashida–Hayasaka–Teruya hard part to the exponent
  3(p^4-p^2+1)/r = (u-1)^2 (u+p) (u^2+p^2-1) + 3
  (cubing is a bijection on mu_r, so the verdict f^E == 1 is unchanged),
  with Granger–Scott cyclotomic squarings inside the u-exponentiations.

A device pairing must match this module ELEMENTWISE pre-final-exp
(same scalings), which is what makes it debuggable step by step.

Reference parity: crypto/bls/src/impls/blst.rs:114-116 delegates this
exact computation (n-pair product + single final exp) to blst.
"""

from . import params
from .params import P, R, X
from . import fields as F

U = X  # signed curve parameter (negative for BLS12-381)

# ------------------------------------------------------------ basis helpers
# Fp12 as 6 Fp2 slots indexed by k = 2i + j for slot (j, i) (basis w^k).


def slots_from_f12(f):
    (a0, a1, a2), (b0, b1, b2) = f
    return [a0, b0, a1, b1, a2, b2]  # k = 0..5


def f12_from_slots(c):
    return ((c[0], c[2], c[4]), (c[1], c[3], c[5]))


def sparse_line(c0, c1, c4):
    """c0 + c1*v + c4*v*w as a full Fp12 element."""
    return ((c0, c1, F.F2_ZERO), (F.F2_ZERO, c4, F.F2_ZERO))


# ------------------------------------------------------------ miller loop

_ATE_BITS = bin(-X)[3:]  # MSB-first bits of |X| after the leading 1


def _dbl_step(T, xP, yP):
    """Jacobian doubling + line through T evaluated at P=(xP,yP) in G1.

    Line (scaled by 2*YT*ZT^3 in Fp2 — killed by final exp):
        c0 = 3 XT^3 - 2 YT^2
        c1 = -3 XT^2 ZT^2 * xP
        c4 =  2 YT ZT^3 * yP
    """
    XT, YT, ZT = T
    A = F.f2sqr(XT)
    Bv = F.f2sqr(YT)
    Cv = F.f2sqr(Bv)
    Zsq = F.f2sqr(ZT)
    D = F.f2sub(F.f2sqr(F.f2add(XT, Bv)), F.f2add(A, Cv))
    D = F.f2add(D, D)
    E = F.f2add(F.f2add(A, A), A)
    Fv = F.f2sqr(E)
    X3 = F.f2sub(Fv, F.f2add(D, D))
    Y3 = F.f2sub(F.f2mul(E, F.f2sub(D, X3)), F.f2smul(Cv, 8))
    Z3 = F.f2add(F.f2mul(YT, ZT), F.f2mul(YT, ZT))
    c0 = F.f2sub(F.f2smul(F.f2mul(XT, A), 3), F.f2add(Bv, Bv))
    c1 = F.f2smul(F.f2mul(A, Zsq), (-3 * xP) % P)
    c4 = F.f2smul(F.f2mul(Z3, Zsq), yP)  # Z3 = 2 YT ZT
    return (X3, Y3, Z3), sparse_line(c0, c1, c4)


def _add_step(T, Q, xP, yP):
    """Mixed addition T += Q (Q affine) + line through T,Q at P.

    With H = U2 - XT (U2 = xQ ZT^2), M = S2 - YT (S2 = yQ ZT^3), the
    line scaled by (-1) * H*ZT (subfield factors; sign killed too):
        c0 = H ZT yQ - M xQ
        c1 = M * xP
        c4 = -H ZT * yP
    """
    XT, YT, ZT = T
    xQ, yQ = Q
    Zsq = F.f2sqr(ZT)
    U2 = F.f2mul(xQ, Zsq)
    S2 = F.f2mul(F.f2mul(yQ, ZT), Zsq)
    H = F.f2sub(U2, XT)
    M = F.f2sub(S2, YT)
    HH = F.f2sqr(H)
    I = F.f2smul(HH, 4)
    J = F.f2mul(H, I)
    rr = F.f2add(M, M)
    V = F.f2mul(XT, I)
    X3 = F.f2sub(F.f2sqr(rr), F.f2add(J, F.f2add(V, V)))
    Y3 = F.f2sub(F.f2mul(rr, F.f2sub(V, X3)), F.f2add(F.f2mul(YT, J), F.f2mul(YT, J)))
    Z3 = F.f2sub(F.f2sqr(F.f2add(ZT, H)), F.f2add(Zsq, HH))
    HZ = F.f2mul(H, ZT)
    c0 = F.f2sub(F.f2mul(HZ, yQ), F.f2mul(M, xQ))
    c1 = F.f2smul(M, xP)
    c4 = F.f2smul(HZ, (-yP) % P)
    return (X3, Y3, Z3), sparse_line(c0, c1, c4)


def miller_loop_fast(p_g1, q_g2):
    """f_{|X|,Q}(P), conjugated at the end for X < 0. Returns Fp12 equal
    to the oracle's miller_loop UP TO subfield factors (same image under
    final exponentiation)."""
    if p_g1 is None or q_g2 is None:
        return F.F12_ONE
    xP, yP = p_g1
    T = (q_g2[0], q_g2[1], F.F2_ONE)
    f = F.F12_ONE
    for b in _ATE_BITS:
        T, line = _dbl_step(T, xP, yP)
        f = F.f12mul(F.f12sqr(f), line)
        if b == "1":
            T, line = _add_step(T, q_g2, xP, yP)
            f = F.f12mul(f, line)
    return F.f12conj(f)  # X < 0: f_{-n} ~ conj(f_n) under final exp


# ------------------------------------------------------------ cyclotomic

# Fp4 = Fp2[t]/(t^2 - xi): (a + b t)^2 = a^2 + xi b^2 + 2ab t.


def _fp4_sqr(a, b):
    a2 = F.f2sqr(a)
    b2 = F.f2sqr(b)
    ra = F.f2add(a2, F.f2mul_xi(b2))
    rb = F.f2sub(F.f2sqr(F.f2add(a, b)), F.f2add(a2, b2))  # 2ab
    return ra, rb


def cyclotomic_sqr(f):
    """Granger–Scott squaring for f in the cyclotomic subgroup.

    Slots k = 2i+j; Fp4 pairs (c0,c3), (c1,c4), (c2,c5):
        (t0a,t0b) = sqr(c0,c3); (t1a,t1b) = sqr(c1,c4); (t2a,t2b) = sqr(c2,c5)
        c0' = 3 t0a - 2 c0        c3' = 3 t0b + 2 c3
        c2' = 3 t1a - 2 c2        c5' = 3 t1b + 2 c5
        c4' = 3 t2a - 2 c4        c1' = 3 xi t2b + 2 c1
    (verified against f12sqr on cyclotomic elements in tests)."""
    c = slots_from_f12(f)
    t0a, t0b = _fp4_sqr(c[0], c[3])
    t1a, t1b = _fp4_sqr(c[1], c[4])
    t2a, t2b = _fp4_sqr(c[2], c[5])
    out = [None] * 6
    out[0] = F.f2sub(F.f2smul(t0a, 3), F.f2smul(c[0], 2))
    out[3] = F.f2add(F.f2smul(t0b, 3), F.f2smul(c[3], 2))
    out[2] = F.f2sub(F.f2smul(t1a, 3), F.f2smul(c[2], 2))
    out[5] = F.f2add(F.f2smul(t1b, 3), F.f2smul(c[5], 2))
    out[4] = F.f2sub(F.f2smul(t2a, 3), F.f2smul(c[4], 2))
    out[1] = F.f2add(F.f2smul(F.f2mul_xi(t2b), 3), F.f2smul(c[1], 2))
    return f12_from_slots(out)


def cyc_pow_abs_u(f):
    """f^|u| with cyclotomic squarings (f must be in the cyclotomic
    subgroup)."""
    bits = bin(-U)[3:]
    out = f
    for b in bits:
        out = cyclotomic_sqr(out)
        if b == "1":
            out = F.f12mul(out, f)
    return out


def cyc_pow_u(f):
    """f^u (u negative: conjugate = inverse in the cyclotomic subgroup)."""
    return F.f12conj(cyc_pow_abs_u(f))


# ------------------------------------------------------------ final exp


def frob(f, n=1):
    """f^(p^n) via the slot gamma constants."""
    out = f
    for _ in range(n):
        out = _frob1(out)
    return out


# gamma constants (same derivation as ops/tower.py)
_G1CONSTS = [F.f2pow(params.XI, k * ((P - 1) // 6)) for k in range(6)]


def _frob1(f):
    c = slots_from_f12(f)
    out = [F.f2mul(F.f2conj(c[k]), _G1CONSTS[k]) for k in range(6)]
    return f12_from_slots(out)


def final_exp_fast(f):
    """Easy part then HHT hard part (exponent 3(p^4-p^2+1)/r)."""
    # easy: f^((p^6-1)(p^2+1))
    t = F.f12mul(F.f12conj(f), F.f12inv(f))       # f^(p^6-1)
    m = F.f12mul(frob(t, 2), t)                   # ^(p^2+1); now cyclotomic
    # hard: m^((u-1)^2 (u+p) (u^2+p^2-1)) * m^3
    a = F.f12mul(cyc_pow_u(m), F.f12conj(m))      # m^(u-1)
    a = F.f12mul(cyc_pow_u(a), F.f12conj(a))      # m^((u-1)^2)
    b = F.f12mul(cyc_pow_u(a), _frob1(a))         # a^(u+p)
    c2 = F.f12mul(cyc_pow_u(cyc_pow_u(b)), F.f12mul(frob(b, 2), F.f12conj(b)))
    #    b^(u^2) * b^(p^2) * b^(-1) = b^(u^2+p^2-1)
    m3 = F.f12mul(F.f12mul(m, m), m)
    return F.f12mul(c2, m3)


def pairings_product_is_one_fast(pairs) -> bool:
    f = F.F12_ONE
    for p_g1, q_g2 in pairs:
        f = F.f12mul(f, miller_loop_fast(p_g1, q_g2))
    return final_exp_fast(f) == F.F12_ONE
