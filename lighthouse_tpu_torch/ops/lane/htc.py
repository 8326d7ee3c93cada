"""Lane-major G2 map-to-curve (SSWU + 3-isogeny + cofactor clearing).

Port of lighthouse_tpu/ops/lane/htc.py, over the port's kernels: every Fp2
product and square outside the ratio chain is `f2mul`/`f2sqr`, the light
reductions `reduce_light`, the G2 group ops `jac_dbl_f2`/`jac_add_f2`. The
number theory is the reference's:

- Inversion-free SSWU: x is carried as the fraction xn/xd, and the square
  root is taken on gn/xd^3 directly: the candidate
  y0 = gn xd^3 (gn xd^9)^((q-9)/16) satisfies y0^2 = (gn/xd^3) chi with
  chi^8 = 1, corrected by one of 4 roots of unity (`_ROOTS`).
- Frobenius-Shamir exponent chain: w^((q-9)/16) = conj(w)^e1 w^e0 with
  (e1, e0) = divmod((q-9)/16, p), one 381-bit two-exponent ladder of joint
  2-bit windows over a 16-entry table.
- Budroni-Pintore clearing with the two static |u| ladders
  (jacobian.scalar_mul_static).

The ratio chain is one kernel, `ratio_chain` (csrc/htc.cu), whose
cooperative programs are traced from its plain body's two parts.

The host feed (SHA-256 expand_message_xmd) is crypto/bls/hash_to_curve.py;
`pack_draws` ships the [2, W, n] Fp2 draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ...crypto.bls import _g2_isogeny_consts as ISO
from ...crypto.bls import fields as FF
from ...crypto.bls import hash_to_curve as H2C
from ...crypto.bls.params import P, X
from . import fastpack, fp, jacobian as J, tower
from .tower import f2mul, f2sqr

W = fp.W
Q = P * P
assert Q % 16 == 9

# ---------------------------------------------------------------- constants
# packed [2, W, 1] (lane dim of 1), recomputed from the host modules

_A = tower.f2_pack(H2C.A_PRIME)
_B = tower.f2_pack(H2C.B_PRIME)
_Z = tower.f2_pack(H2C.Z)
_NEG_B = tower.f2_pack(FF.f2neg(H2C.B_PRIME))
_ZA = tower.f2_pack(FF.f2mul(H2C.Z, H2C.A_PRIME))
_Z3_VAL = FF.f2mul(FF.f2sqr(H2C.Z), H2C.Z)
_Z3 = tower.f2_pack(_Z3_VAL)
_C2 = tower.f2_pack(FF.f2pow(_Z3_VAL, (Q + 7) // 16))
_ROOT_U = FF.f2sqrt((0, 1))
_ROOT_NU = FF.f2sqrt((0, P - 1))
assert _ROOT_U is not None and _ROOT_NU is not None
_ROOTS = np.stack(
    [
        tower.f2_pack(FF.F2_ONE),
        tower.f2_pack((0, 1)),
        tower.f2_pack(_ROOT_U),
        tower.f2_pack(_ROOT_NU),
    ]
)  # [4, 2, W, 1]
_ONE2 = np.stack([fp.ONE, fp.ZERO])[..., None].astype(np.int32)  # [2, W, 1]

_ISO_XNUM = [tower.f2_pack(c) for c in ISO.XNUM]
_ISO_XDEN = [tower.f2_pack(c) for c in ISO.XDEN]
_ISO_YNUM = [tower.f2_pack(c) for c in ISO.YNUM]
_ISO_YDEN = [tower.f2_pack(c) for c in ISO.YDEN]

# ratio exponent chain: w^_EXP_R == conj(w)^_E1 * w^_E0
_EXP_R = (Q - 9) // 16
_E1, _E0 = divmod(_EXP_R, P)
_NW = (max(_E1.bit_length(), _E0.bit_length()) + 1) // 2
_WIN_IDX = [
    (((_E1 >> (2 * k)) & 3) << 2) | ((_E0 >> (2 * k)) & 3)
    for k in reversed(range(_NW))
]

_NAMED = {
    "A": _A, "B": _B, "Z": _Z, "NEG_B": _NEG_B, "ZA": _ZA, "Z3": _Z3,
    "C2": _C2, "ROOTS": _ROOTS, "ONE2": _ONE2,
}
_DEVICE_CONSTS: dict = {}


def _consts(device) -> dict:
    """The packed constants as tensors on `device` (made once per device);
    the isogeny coefficients as lists under ISO_XNUM, ... ."""
    device = torch.device(device)
    c = _DEVICE_CONSTS.get(device)
    if c is None:
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

        c = {name: t(a) for name, a in _NAMED.items()}
        for name, coeffs in (("ISO_XNUM", _ISO_XNUM), ("ISO_XDEN", _ISO_XDEN),
                             ("ISO_YNUM", _ISO_YNUM), ("ISO_YDEN", _ISO_YDEN)):
            c[name] = [t(a) for a in coeffs]
        _DEVICE_CONSTS[device] = c
    return c


def _bc(const, S):
    return tower.bcast(const, S)


# ------------------------------------------------- ratio exponent chain


def _ratio_table_body(folds, topf, w, one):
    """The chain's 16 entries table[4*i + j] = conj(w)^i * w^j, stacked
    [..., 16, 2, W, S]: w^2 (one f2sqr), w^3 (one f2mul), the 9 products
    in one stacked f2mul. `one`: entry 0 (a row of the table program; the
    kernel writes it)."""
    w1 = fp._norm(w, topf, "htc.ratio_chain.entry")
    w2 = tower._f2sqr_body(folds, topf, w1)
    w3 = tower._f2mul_body(folds, topf, w2, w1)
    cw1, cw2, cw3 = (tower.f2conj(v) for v in (w1, w2, w3))
    aa = torch.stack([cw1, cw1, cw1, cw2, cw2, cw2, cw3, cw3, cw3], 0)
    bb = torch.stack([w1, w2, w3] * 3, 0)
    pr = tower._f2mul_body(folds, topf, aa, bb)  # [9, ..., 2, W, S]
    return torch.stack(
        [
            one, w1, w2, w3,
            cw1, pr[0], pr[1], pr[2],
            cw2, pr[3], pr[4], pr[5],
            cw3, pr[6], pr[7], pr[8],
        ],
        -4,
    )


def _ratio_win_body(folds, topf, acc, e):
    """One window of the chain: acc^4 * e (two f2sqr, one f2mul)."""
    acc = tower._f2sqr_body(folds, topf, tower._f2sqr_body(folds, topf, acc))
    return tower._f2mul_body(folds, topf, acc, e)


def _ratio_chain_body(folds, topf, w, one=None):
    """w^((q-9)/16), the plain version of the `ratio_chain` kernel: the
    table, then MSB-first one window a digit of _WIN_IDX from entry 0.
    It makes the Fp2 products and squares in the order the reference's
    chain launches `f2sqr` and `f2mul`, so the limbs are the reference's.
    The kernel (csrc/htc.cu) runs the programs traced from
    `_ratio_table_body` and `_ratio_win_body` (ops/lane/coop.py)."""
    if one is None:
        one = _bc(_consts(w.device)["ONE2"], w.shape[-1]).expand(w.shape)
    table = _ratio_table_body(folds, topf, w, one)
    acc = table[..., 0, :, :, :]
    for idx in _WIN_IDX:
        acc = _ratio_win_body(folds, topf, acc, table[..., idx, :, :, :])
    return acc


# one launch per chain: 1,369 Fp products and 402 reduce_light on a block
# of warps per lane element (csrc/htc.cu)
ratio_chain_op = fp.KernelOp(_ratio_chain_body, "ratio_chain", "lh_ratio_chain")


def ratio_chain(w):
    """w^((q-9)/16) = conj(w)^e1 * w^e0: one 381-bit Shamir chain, in one
    kernel (`ratio_chain`).

    MSB-first joint 2-bit windows; per step acc = acc^4 * table[idx],
    where table[4*i + j] = conj(w)^i * w^j (16 entries, 9 products in one
    stacked f2mul)."""
    return ratio_chain_op(w)


# ---------------------------------------------------------------- sgn0


def f2_sgn0(a):
    """RFC 9380 sgn0 for Fp2 (batched), on canonical limbs. [..., S]."""
    c = fp.canonical(a)
    a0, a1 = c[..., 0, :, :], c[..., 1, :, :]
    s0 = a0[..., 0, :] & 1
    z0 = (a0 == 0).all(dim=-2)
    s1 = a1[..., 0, :] & 1
    return s0 | (z0.to(torch.int32) & s1)


# ---------------------------------------------------------------- SSWU


def _sqrt_ratio_cand(u, v):
    """Candidate square root of u/v: y0 = u v (u v^3)^((q-9)/16)."""
    v2 = f2sqr(v)
    v3 = f2mul(v2, v)
    c = ratio_chain(f2mul(u, v3))
    return f2mul(f2mul(u, v), c)


def _pick_root_ratio(cand, num, den, S):
    """(y, found): y = cand * root for the first correction root with
    y^2 * den == num; found = any. One stacked f2sqr/f2mul pass over the
    4 candidates."""
    roots = _bc(_consts(cand.device)["ROOTS"], S)          # [4, 2, W, S]
    cands = f2mul(roots, cand[..., None, :, :, :])         # [.., 4, 2, W, S]
    lhs = f2mul(f2sqr(cands), den[..., None, :, :, :])
    ok = tower.f2_eq(lhs, num[..., None, :, :, :])          # [.., 4, S]
    found = ok.any(dim=-2)
    y = cands[..., 0, :, :, :]
    for k in (1, 2, 3):
        take = ok[..., k, :] & ~ok[..., :k, :].any(dim=-2)
        y = torch.where(take[..., None, None, :], cands[..., k, :, :, :], y)
    return y, found


def map_to_curve(t):
    """Batched inversion-free SSWU: Fp2 draws [..., 2, W, S] -> E2' point
    as (xn, xd, y): x = xn/xd projective, y affine."""
    S = t.shape[-1]
    c = _consts(t.device)
    one2 = _bc(c["ONE2"], S)
    t2 = f2sqr(t)
    zt2 = f2mul(_bc(c["Z"], S), t2)
    zt2sq = f2sqr(zt2)
    tv1 = fp.reduce_light(zt2sq + zt2)
    tv1_zero = tower.f2_eq_zero(tv1)[..., None, None, :]
    xn = f2mul(_bc(c["NEG_B"], S), fp.reduce_light(tv1 + one2))
    xn = torch.where(tv1_zero, _bc(c["B"], S), xn)
    xd = f2mul(_bc(c["A"], S), tv1)
    xd = torch.where(tv1_zero, _bc(c["ZA"], S), xd)
    # g(x1) = gn / xd^3
    xd2 = f2sqr(xd)
    xd3 = f2mul(xd2, xd)
    xn2 = f2sqr(xn)
    xn3 = f2mul(xn2, xn)
    gn = fp.reduce_light(
        xn3
        + f2mul(_bc(c["A"], S), f2mul(xn, xd2))
        + f2mul(_bc(c["B"], S), xd3)
    )
    y0 = _sqrt_ratio_cand(gn, xd3)
    y1, is_sq = _pick_root_ratio(y0, gn, xd3, S)
    # non-square branch: x2 = zt2 * x1 (same xd), g(x2) = Z^3 t^6 g(x1)
    t3 = f2mul(t2, t)
    y2a = f2mul(f2mul(t3, _bc(c["C2"], S)), y0)
    gn2 = f2mul(_bc(c["Z3"], S), f2mul(f2sqr(t3), gn))
    y2, _ = _pick_root_ratio(y2a, gn2, xd3, S)
    sq = is_sq[..., None, None, :]
    x_out = torch.where(sq, xn, f2mul(zt2, xn))
    y = torch.where(sq, y1, y2)
    flip = f2_sgn0(y) != f2_sgn0(t)
    y = torch.where(flip[..., None, None, :], -y, y)
    return x_out, xd, y


# ---------------------------------------------------------------- isogeny


def iso_map(xn, xd, y):
    """Homogenized projective 3-isogeny E2' -> E2: Jacobian (X, Y, Z).

    Each coefficient polynomial p of degree L-1 is evaluated as
    p_h = sum_i k_i xn^i xd^(L-1-i) = p(xn/xd) xd^(L-1) by Horner against
    precomputed powers of xd; with (Lx, Lxd, Ly, Lyd) = (4, 3, 5, 5) the
    point is x = xnum_h / (xden_h xd), y_aff = y ynum_h / yden_h."""
    S = xn.shape[-1]
    c = _consts(xn.device)
    d2 = f2sqr(xd)
    d3 = f2mul(d2, xd)
    d4 = f2sqr(d2)
    dpow = [None, xd, d2, d3, d4]

    def ev(coeffs):
        acc = _bc(coeffs[-1], S)
        for k, co in enumerate(coeffs[-2::-1], start=1):
            acc = fp.reduce_light(f2mul(acc, xn) + f2mul(_bc(co, S), dpow[k]))
        return acc

    xnum = ev(c["ISO_XNUM"])
    xden = ev(c["ISO_XDEN"])
    ynum = ev(c["ISO_YNUM"])
    yden = ev(c["ISO_YDEN"])
    XD = f2mul(xden, xd)
    Z = f2mul(XD, yden)
    yden2 = f2sqr(yden)
    Xo = f2mul(f2mul(xnum, XD), yden2)
    Yo = f2mul(f2mul(y, ynum), f2mul(f2mul(f2sqr(XD), XD), yden2))
    return (Xo, Yo, Z)


# ---------------------------------------------------------------- clearing

_M_ABS = -X  # |u|, positive


def clear_cofactor(p):
    """Budroni-Pintore: h_eff P = [m^2]P + [m]P - P - psi([m]P + P)
    + psi^2(2P), m = |u|, both ladders static."""
    a1 = J.scalar_mul_static(J.FP2, p, _M_ABS)        # [m]P
    a2 = J.scalar_mul_static(J.FP2, a1, _M_ABS)       # [m^2]P
    s1 = J.add(J.FP2, a1, p, exact=True)              # [m]P + P
    res = J.add(J.FP2, a2, a1, exact=True)
    res = J.add(J.FP2, res, J.neg(J.FP2, p), exact=True)
    res = J.add(J.FP2, res, J.neg(J.FP2, J.psi(s1)), exact=True)
    dbl = J.double(J.FP2, p)
    res = J.add(J.FP2, res, J.psi(J.psi(dbl)), exact=True)
    return res


def hash_draws_to_g2(t0, t1):
    """Two Fp2 draws per message -> G2 point (Jacobian), batched along the
    lane axis. The two SWU maps run as ONE doubled lane batch."""
    n = t0.shape[-1]
    t = torch.cat([t0, t1], dim=-1)
    q = iso_map(*map_to_curve(t))
    q0 = tuple(c[..., :n] for c in q)
    q1 = tuple(c[..., n:] for c in q)
    return clear_cofactor(J.add(J.FP2, q0, q1, exact=True))


# ---------------------------------------------------------------- host feed


def pack_draws(messages):
    """Host: messages -> (t0, t1), Fp2 limb arrays [2, W, n] each (numpy).
    The SHA-256 expansion runs once per distinct message (a batch repeats
    its padding message b"" and a committee's message), the packing
    through the vectorized `fastpack`."""
    t0s, t1s = [], []
    draws = {}
    for m in messages:
        hit = draws.get(m)
        if hit is None:
            hit = draws[m] = H2C.hash_to_field_fp2(m, 2)
        t0s.append(hit[0])
        t1s.append(hit[1])
    return fastpack.f2_pack_many(t0s), fastpack.f2_pack_many(t1s)
