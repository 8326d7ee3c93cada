"""Lane-major Jacobian group ops for G1 (over Fp), with CUDA kernels.

Port of the G1 half of lighthouse_tpu/ops/lane/jacobian.py: the same
formulas (dbl-2009-l, add-2007-bl), the same completeness scheme
(structural infinity Z == 0, limb for limb) and the same op table. `double`
and the branchless `add` each launch ONE kernel on CUDA tensors
(`jac_dbl_f1`, `jac_add_f1`, csrc/jac_dbl.cu and csrc/jac_add.cu); the
bodies below are their plain PyTorch versions. `add(exact=True)` composes
the collision check from `mul`/`sqr`/`eq_zero` around the kernel.

Points are (X, Y, Z) tuples of lane-major field tensors [..., W, S].
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ...crypto.bls.params import P
from . import fp

W = fp.W


def _wh(flag, a, b):
    """Select by a [..., S] lane flag over field tensors [..., W, S]."""
    return torch.where(flag[..., None, :], a, b)


def _is_zero(Z):
    """Structural infinity: every limb exactly 0 (not === 0 mod p)."""
    return (Z == 0).all(dim=-2)


# ------------------------------------------------------------ plain bodies


def _dbl_body(folds, topf, X, Y, Z):
    def S(v):
        return fp._sqr_fn(folds, topf, v)

    def M(u, v):
        return fp._mul_fn(folds, topf, u, v)

    def RL(v):
        return fp._reduce_light_body(v, folds, topf)

    A = S(X)
    Bv = S(Y)
    Cv = S(Bv)
    D = RL(S(X + Bv) - A - Cv)
    D = D + D
    E = A + A + A
    F = S(E)
    X3 = RL(F - D - D)
    Y3 = RL(M(E, D - X3) - 8 * Cv)
    Z3 = RL(2 * M(Y, Z))
    return X3, Y3, Z3


def _add_body(folds, topf, X1, Y1, Z1, X2, Y2, Z2):
    def S(v):
        return fp._sqr_fn(folds, topf, v)

    def M(u, v):
        return fp._mul_fn(folds, topf, u, v)

    def RL(v):
        return fp._reduce_light_body(v, folds, topf)

    Z1Z1 = S(Z1)
    Z2Z2 = S(Z2)
    U1 = M(X1, Z2Z2)
    U2 = M(X2, Z1Z1)
    S1 = M(M(Y1, Z2), Z2Z2)
    S2 = M(M(Y2, Z1), Z1Z1)
    H = U2 - U1
    I = S(H + H)
    J = M(H, I)
    r = 2 * (S2 - S1)
    V = M(U1, I)
    X3 = RL(S(r) - J - 2 * V)
    Y3 = RL(M(r, V - X3) - 2 * M(S1, J))
    Z3 = RL(M(RL(S(Z1 + Z2) - Z1Z1 - Z2Z2), H))
    # structural-infinity selection, inside the kernel
    p1_inf = _is_zero(Z1)
    p2_inf = _is_zero(Z2)
    return tuple(
        _wh(p1_inf, b, _wh(p2_inf, a, o))
        for a, b, o in ((X1, X2, X3), (Y1, Y2, Y3), (Z1, Z2, Z3))
    )


_dbl_f1 = fp.KernelOp(_dbl_body, "jac_dbl_f1", "lh_jac_dbl_f1", 3)
_add_f1 = fp.KernelOp(_add_body, "jac_add_f1", "lh_jac_add_f1", 3)


FP1 = SimpleNamespace(
    mul=fp.mul,
    sqr=fp.sqr,
    eq_zero=fp.eq_zero,
    is_zero_struct=_is_zero,
    wh=_wh,
    zeros=lambda shape, S, device: torch.zeros(
        (*shape, W, S), dtype=torch.int32, device=device
    ),
    dbl=_dbl_f1,
    addk=_add_f1,
)


# ---------------------------------------------------------------- host codecs


def pack_g1(points, device) -> tuple:
    """Affine points/None -> (X, Y, Z) [W, n] tensors; None -> Z = 0."""
    xs = fp.pack([0 if pt is None else pt[0] for pt in points])
    ys = fp.pack([0 if pt is None else pt[1] for pt in points])
    zs = fp.pack([0 if pt is None else 1 for pt in points])
    return tuple(torch.from_numpy(a).to(device) for a in (xs, ys, zs))


def unpack_g1(pt):
    """Jacobian point(s) -> list of affine tuples/None (host)."""
    X, Y, Z = (a.cpu().numpy() for a in pt)
    out = []
    for s in range(X.shape[-1]):
        zv = fp.from_limbs(Z[..., :, s])
        if zv == 0:
            out.append(None)
            continue
        zi = pow(zv, P - 2, P)
        out.append(
            (
                fp.from_limbs(X[..., :, s]) * zi * zi % P,
                fp.from_limbs(Y[..., :, s]) * zi * zi % P * zi % P,
            )
        )
    return out


# ---------------------------------------------------------------- core ops


def double(ops, p):
    return ops.dbl(*p)


def add(ops, p1, p2, exact: bool = False):
    """Fused branchless add; exact=True resolves H == 0 collisions
    (doubling / infinity) with canonical compares around the kernel."""
    out = ops.addk(*p1, *p2)
    if exact:
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        Z1Z1 = ops.sqr(Z1)
        Z2Z2 = ops.sqr(Z2)
        H = ops.mul(X2, Z1Z1) - ops.mul(X1, Z2Z2)
        r = ops.mul(ops.mul(Y2, Z1), Z1Z1) - ops.mul(ops.mul(Y1, Z2), Z2Z2)
        h_zero = ops.eq_zero(H)
        r_zero = ops.eq_zero(r)
        dbl = double(ops, p1)
        both = h_zero & r_zero
        # collision logic only applies when neither input is infinity
        neither = ~(ops.is_zero_struct(Z1) | ops.is_zero_struct(Z2))
        out = tuple(
            ops.wh(neither & both, d, ops.wh(neither & h_zero, torch.zeros_like(o), o))
            for d, o in zip(dbl, out)
        )
    return out


def neg(ops, p):
    return (p[0], -p[1], p[2])


def lane_sum(ops, p, n: int):
    """Complete sum over the LANE axis: [..., W, S] -> [..., W, 1].

    Tree reduction by lane halving: log2(S) exact adds, each over a
    halved lane dim. Padding lanes (>= n) and any pad to the next power of
    two enter as structural infinity (Z = 0)."""
    S = p[0].shape[-1]
    if n < S:
        mask = torch.arange(S, device=p[0].device) < n
        p = tuple(torch.where(mask, c, torch.zeros_like(c)) for c in p)
    full = 1 << (S - 1).bit_length()
    if full != S:
        p = tuple(torch.nn.functional.pad(c, (0, full - S)) for c in p)
        S = full
    while S > 1:
        half = S // 2
        a = tuple(c[..., :half] for c in p)
        b = tuple(c[..., half:] for c in p)
        p = add(ops, a, b, exact=True)
        S = half
    return p


def scalars_to_bits(scalars, nbits: int) -> np.ndarray:
    """Host: python ints -> [nbits, n] int32 LSB-first bit matrix
    (lane-major: bit index leads, batch on lanes)."""
    out = np.zeros((nbits, len(scalars)), dtype=np.int32)
    for i, s in enumerate(scalars):
        for j in range(nbits):
            out[j, i] = (s >> j) & 1
    return out
