"""Lane-major Jacobian group ops for G1 (over Fp) and G2 (over Fp2), with
CUDA kernels.

Port of lighthouse_tpu/ops/lane/jacobian.py: the same formulas (dbl-2009-l,
add-2007-bl), the same completeness scheme (structural infinity: every limb
of Z exactly 0, of both components over Fp2) and the same op tables. The
bodies are field-generic, as the reference's (`f2` flag). `double` and the
branchless `add` each launch ONE kernel on CUDA tensors (`jac_dbl_f1`,
`jac_add_f1`, `jac_dbl_f2`, `jac_add_f2`: csrc/jac_dbl.cu and
csrc/jac_add.cu, all four cooperative, their programs traced from
`_dbl_f1_body`, `_add_core_f1`, `_dbl_f2_body` and `_add_core_f2` by
coop.py, the adds' infinity selects in their kernels' epilogue), and so
does one step of the per-lane dynamic ladder (`ladder_step_f1`,
`ladder_step_f2`: csrc/ladder.cu, cooperative, running the add's program
where the lane's bit is set and the doubling's, with the bit and the
infinity selects uniform over the block); the bodies below are their
plain PyTorch versions.
`add(exact=True)` over G1 launches ONE kernel too (`add_exact_f1`,
csrc/jac_add.cu, cooperative: its program traced from `_add_exact_core_f1`,
the add, the doubling of P1 and the collision check's H and R in one
program, the canonical() zero tests and the select in its epilogue); over
G2 it composes the collision check from `mul`/`sqr`/`eq_zero` around the
add kernel, as the reference does. The ladders (`scalar_mul`,
`scalar_mul_static`, `scalar_mul_with_static`) are Python loops over the
scalars' bits that make the reference's scan + cond calls, call for call.

Points are (X, Y, Z) tuples of lane-major field tensors: Fp [..., W, S],
Fp2 [..., 2, W, S].
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ...crypto.bls import fields as FF
from ...crypto.bls.params import P
from . import fp, tower

W = fp.W


def _wh(flag, a, b, ncomp: int = 1):
    """Select by a [..., S] lane flag over field tensors with `ncomp`
    element dims before the lane axis ([..., W, S]: 1; [..., 2, W, S]: 2)."""
    return torch.where(flag[(..., *([None] * ncomp), slice(None))], a, b)


def _is_zero(Z, ncomp: int = 1):
    """Structural infinity: every limb exactly 0 (not === 0 mod p), over
    all `ncomp` element dims. Shape [..., S]."""
    return (Z == 0).all(dim=-2) if ncomp == 1 else (Z == 0).flatten(-3, -2).all(dim=-2)


# ------------------------------------------------------------ plain bodies


def _field(folds, topf, f2: bool):
    """(S, M, RL) of the bodies: square, product and light reduction over
    Fp (`_sqr_fn`, `_mul_fn`) or Fp2 (`_f2sqr_body`, `_f2mul_body`)."""
    if f2:
        return (
            lambda v: tower._f2sqr_body(folds, topf, v),
            lambda u, v: tower._f2mul_body(folds, topf, u, v),
            lambda v: fp._reduce_light_body(v, folds, topf),
        )
    return (
        lambda v: fp._sqr_fn(folds, topf, v),
        lambda u, v: fp._mul_fn(folds, topf, u, v),
        lambda v: fp._reduce_light_body(v, folds, topf),
    )


def _dbl_body(folds, topf, X, Y, Z, f2: bool = False):
    S, M, RL = _field(folds, topf, f2)
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


def _add_parts(folds, topf, X1, Y1, Z1, X2, Y2, Z2, f2: bool = False):
    """add-2007-bl without the infinity selection: the sum's (X3, Y3, Z3),
    and the exact add's collision check H = U2 - U1 and R = S2 - S1 (lazy;
    `add(exact=True)`'s mul(X2, Z1Z1) - mul(X1, Z2Z2) and mul(mul(Y2, Z1),
    Z1Z1) - mul(mul(Y1, Z2), Z2Z2), limb for limb)."""
    S, M, RL = _field(folds, topf, f2)
    Z1Z1 = S(Z1)
    Z2Z2 = S(Z2)
    U1 = M(X1, Z2Z2)
    U2 = M(X2, Z1Z1)
    S1 = M(M(Y1, Z2), Z2Z2)
    S2 = M(M(Y2, Z1), Z1Z1)
    H = U2 - U1
    I = S(H + H)  # noqa: E741  (the formula's name)
    J = M(H, I)
    r = 2 * (S2 - S1)
    V = M(U1, I)
    X3 = RL(S(r) - J - 2 * V)
    Y3 = RL(M(r, V - X3) - 2 * M(S1, J))
    Z3 = RL(M(RL(S(Z1 + Z2) - Z1Z1 - Z2Z2), H))
    return (X3, Y3, Z3), H, S2 - S1


def _add_core(folds, topf, X1, Y1, Z1, X2, Y2, Z2, f2: bool = False):
    """add-2007-bl without the infinity selection: the sum's (X3, Y3, Z3)."""
    return _add_parts(folds, topf, X1, Y1, Z1, X2, Y2, Z2, f2=f2)[0]


def _add_select(p1, p2, total, f2: bool = False):
    """The structural-infinity selection of the add: P2 where P1 is at
    infinity, else P1 where P2 is, else the sum (three points)."""
    nc = 2 if f2 else 1
    p1_inf = _is_zero(p1[2], nc)
    p2_inf = _is_zero(p2[2], nc)
    return tuple(
        _wh(p1_inf, b, _wh(p2_inf, a, o, nc), nc) for a, b, o in zip(p1, p2, total)
    )


def _add_body(folds, topf, X1, Y1, Z1, X2, Y2, Z2, f2: bool = False):
    total = _add_core(folds, topf, X1, Y1, Z1, X2, Y2, Z2, f2=f2)
    # structural-infinity selection, inside the kernel
    return _add_select((X1, Y1, Z1), (X2, Y2, Z2), total, f2=f2)


def _add_exact_core(folds, topf, X1, Y1, Z1, X2, Y2, Z2, f2: bool = False):
    """The exact add's arithmetic without its selects: the sum's (X3, Y3,
    Z3), the doubling of P1 and the collision check's H and R, 8 values.
    The check takes no product of its own: H and R are linear in the sum's
    U1, U2, S1, S2."""
    total, H, R = _add_parts(folds, topf, X1, Y1, Z1, X2, Y2, Z2, f2=f2)
    return (*total, *_dbl_body(folds, topf, X1, Y1, Z1, f2=f2), H, R)


def _add_exact_flags(folds, topf, Z1, Z2, H, R, f2: bool = False):
    """(P1 at infinity, P2 at infinity, H === 0, R === 0), each [..., S]:
    the structural tests, and canonical() (`fp._canonical_fn`) of H and R
    with every limb 0, as `eq_zero` tests them."""
    nc = 2 if f2 else 1
    h, r = (fp._canonical_fn(folds, topf, v) for v in (H, R))
    return _is_zero(Z1, nc), _is_zero(Z2, nc), _is_zero(h, nc), _is_zero(r, nc)


def _add_exact_select(p1, p2, total, dbl, flags, f2: bool = False):
    """The reference's exact-add select, in its order: neither point at
    infinity and H === R === 0 -> the doubling of P1; else neither at
    infinity and H === 0 -> infinity (zeros); else `_add_select`'s P2, P1
    or the sum."""
    nc = 2 if f2 else 1
    p1_inf, p2_inf, h_zero, r_zero = flags
    neither = ~(p1_inf | p2_inf)
    out = _add_select(p1, p2, total, f2=f2)
    return tuple(
        _wh(neither & h_zero & r_zero, d, _wh(neither & h_zero, torch.zeros_like(o), o, nc), nc)
        for d, o in zip(dbl, out)
    )


def _add_exact_body(folds, topf, X1, Y1, Z1, X2, Y2, Z2, f2: bool = False):
    out = _add_exact_core(folds, topf, X1, Y1, Z1, X2, Y2, Z2, f2=f2)
    flags = _add_exact_flags(folds, topf, Z1, Z2, out[6], out[7], f2=f2)
    return _add_exact_select((X1, Y1, Z1), (X2, Y2, Z2), out[:3], out[3:6], flags, f2=f2)


def _ladder_step_body(folds, topf, X1, Y1, Z1, Xa, Ya, Za, bit, f2: bool = False):
    """One step of the per-lane dynamic ladder: the branchless add of the
    addend into the accumulator, kept on the lanes whose bit [..., 1, S]
    is set, and the doubling of the addend. Returns the 3 accumulator
    coordinates, then the 3 doubled-addend coordinates."""
    added = _add_body(folds, topf, X1, Y1, Z1, Xa, Ya, Za, f2=f2)
    nc = 2 if f2 else 1
    flag = bit[..., 0, :] != 0
    acc = tuple(_wh(flag, a, o, nc) for a, o in zip(added, (X1, Y1, Z1)))
    return (*acc, *_dbl_body(folds, topf, Xa, Ya, Za, f2=f2))


def _ladder_step_f1_body(folds, topf, *args):
    return _ladder_step_body(folds, topf, *args, f2=False)


def _ladder_step_f2_body(folds, topf, *args):
    return _ladder_step_body(folds, topf, *args, f2=True)


def _dbl_f1_body(folds, topf, X, Y, Z):
    return _dbl_body(folds, topf, X, Y, Z, f2=False)


def _dbl_f2_body(folds, topf, X, Y, Z):
    return _dbl_body(folds, topf, X, Y, Z, f2=True)


def _add_f1_body(folds, topf, *args):
    return _add_body(folds, topf, *args, f2=False)


def _add_f2_body(folds, topf, *args):
    return _add_body(folds, topf, *args, f2=True)


def _add_core_f1(folds, topf, *args):
    return _add_core(folds, topf, *args, f2=False)


def _add_core_f2(folds, topf, *args):
    return _add_core(folds, topf, *args, f2=True)


def _add_exact_core_f1(folds, topf, *args):
    return _add_exact_core(folds, topf, *args, f2=False)


def _add_exact_f1_body(folds, topf, *args):
    return _add_exact_body(folds, topf, *args, f2=False)


_dbl_f1 = fp.KernelOp(_dbl_f1_body, "jac_dbl_f1", "lh_jac_dbl_f1")
_dbl_f2 = fp.KernelOp(_dbl_f2_body, "jac_dbl_f2", "lh_jac_dbl_f2")
_add_f1 = fp.KernelOp(_add_f1_body, "jac_add_f1", "lh_jac_add_f1")
_add_f2 = fp.KernelOp(_add_f2_body, "jac_add_f2", "lh_jac_add_f2")
_add_exact_f1 = fp.KernelOp(_add_exact_f1_body, "add_exact_f1", "lh_add_exact_f1")
_ladder_step_f1 = fp.KernelOp(_ladder_step_f1_body, "ladder_step_f1", "lh_ladder_step_f1")
_ladder_step_f2 = fp.KernelOp(_ladder_step_f2_body, "ladder_step_f2", "lh_ladder_step_f2")


FP1 = SimpleNamespace(
    name="fp",
    ndim=1,
    mul=fp.mul,
    sqr=fp.sqr,
    eq_zero=fp.eq_zero,
    is_zero_struct=lambda a: _is_zero(a, 1),
    wh=lambda f, a, b: _wh(f, a, b, 1),
    zeros=lambda shape, S, device: torch.zeros(
        (*shape, W, S), dtype=torch.int32, device=device
    ),
    dbl=_dbl_f1,
    addk=_add_f1,
    add_exact=_add_exact_f1,
    ladder_step=_ladder_step_f1,
)

FP2 = SimpleNamespace(
    name="fp2",
    ndim=2,
    mul=tower.f2mul,
    sqr=tower.f2sqr,
    eq_zero=tower.f2_eq_zero,
    is_zero_struct=lambda a: _is_zero(a, 2),
    wh=lambda f, a, b: _wh(f, a, b, 2),
    zeros=lambda shape, S, device: torch.zeros(
        (*shape, 2, W, S), dtype=torch.int32, device=device
    ),
    dbl=_dbl_f2,
    addk=_add_f2,
    ladder_step=_ladder_step_f2,
)


# ---------------------------------------------------------------- host codecs


def pack_g1(points, device) -> tuple:
    """Affine points/None -> (X, Y, Z) [W, n] tensors; None -> Z = 0."""
    xs = fp.pack([0 if pt is None else pt[0] for pt in points])
    ys = fp.pack([0 if pt is None else pt[1] for pt in points])
    zs = fp.pack([0 if pt is None else 1 for pt in points])
    return tuple(torch.from_numpy(a).to(device) for a in (xs, ys, zs))


def pack_g2(points, device) -> tuple:
    """Affine G2 points/None -> (X, Y, Z) [2, W, n] tensors; None -> Z = 0."""
    z2, one2 = (0, 0), (1, 0)
    xs = tower.f2_pack_many([z2 if pt is None else pt[0] for pt in points])
    ys = tower.f2_pack_many([z2 if pt is None else pt[1] for pt in points])
    zs = tower.f2_pack_many([z2 if pt is None else one2 for pt in points])
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


def unpack_g2(pt):
    """Jacobian G2 point(s) [2, W, S] -> list of affine tuples/None (host)."""
    X, Y, Z = (a.cpu().numpy() for a in pt)

    def f2(a, s):
        return (fp.from_limbs(a[0, :, s]), fp.from_limbs(a[1, :, s]))

    out = []
    for s in range(X.shape[-1]):
        z = f2(Z, s)
        if z == (0, 0):
            out.append(None)
            continue
        zi = FF.f2inv(z)
        zi2 = FF.f2sqr(zi)
        out.append((FF.f2mul(f2(X, s), zi2), FF.f2mul(f2(Y, s), FF.f2mul(zi2, zi))))
    return out


# ---------------------------------------------------------------- core ops


def infinity_like(ops, base):
    """The point at infinity (Z = 0) in the shape of the point `base`."""
    S = base[0].shape[-1]
    shape = base[0].shape[: base[0].dim() - ops.ndim - 1]
    return tuple(ops.zeros(shape, S, base[0].device) for _ in range(3))


def double(ops, p):
    return ops.dbl(*p)


def add(ops, p1, p2, exact: bool = False):
    """Fused branchless add; exact=True resolves H == 0 collisions
    (doubling / infinity): in one kernel where the namespace has one
    (`add_exact`, G1), else with canonical compares around the add
    kernel."""
    if exact and getattr(ops, "add_exact", None) is not None:
        return ops.add_exact(*p1, *p2)
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


def scalar_mul(ops, base, bits):
    """[k]base for per-lane scalars; bits [nbits, S] int32 or bool, LSB
    first (the scalars_to_bits layout). One `ladder_step` per bit from the
    infinity accumulator: the add is computed on every lane and kept where
    the lane's bit is set, and the addend doubles (the last step's
    doubling included, as the reference's scan makes it).

    The add is not the exact one: for a base in the r-torsion the
    accumulator [k mod 2^i]P never equals the addend [2^i]P, and the
    infinity cases are structural inside the add."""
    acc = infinity_like(ops, base)
    addend = base
    rows = bits.to(torch.int32)[:, None, :]  # [nbits, 1, S]
    for i in range(rows.shape[0]):
        out = ops.ladder_step(*acc, *addend, rows[i])
        acc, addend = out[:3], out[3:]
    return acc


def scalar_mul_with_static(ops, base, bits, static_scalar: int):
    """([k]base, [static_scalar]base) on ONE doubling chain: per step one
    `ladder_step` for the per-lane scalars (bits as in `scalar_mul`, zero
    past their end), then, at the static scalar's set bits, an `add` of
    the addend into the static accumulator. That add takes the addend from
    BEFORE the step's doubling (the kernel returns the doubled chain for
    the next step): the reference's scan + cond makes the same calls."""
    nbits = bits.shape[0]
    last = max(nbits, static_scalar.bit_length())
    acc = acc_s = infinity_like(ops, base)
    addend = base
    rows = bits.to(torch.int32)[:, None, :]  # [nbits, 1, S]
    zero_row = torch.zeros_like(rows[0])
    for i in range(last):
        out = ops.ladder_step(*acc, *addend, rows[i] if i < nbits else zero_row)
        if (static_scalar >> i) & 1:
            acc_s = add(ops, acc_s, addend)
        acc, addend = out[:3], out[3:]
    return acc, acc_s


def scalar_mul_static(ops, base, scalar: int):
    """[scalar]base for a STATIC scalar > 0: a loop over its bits, LSB
    first, from the infinity accumulator: `add` at every set bit (the
    first one into infinity included), `double` of the addend at every
    bit (the last one included). The reference's scan with the add under
    lax.cond makes the same calls."""
    assert scalar > 0
    acc = infinity_like(ops, base)
    addend = base
    for i in range(scalar.bit_length()):
        if (scalar >> i) & 1:
            acc = add(ops, acc, addend)
        addend = double(ops, addend)
    return acc


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


# ---------------------------------------------------------------- G2 psi

PSI_CX = tower.f2_pack(FF.PSI_CX)  # [2, W, 1]
PSI_CY = tower.f2_pack(FF.PSI_CY)
_DEVICE_CONSTS: dict = {}


def _psi_consts(device):
    device = torch.device(device)
    c = _DEVICE_CONSTS.get(device)
    if c is None:
        c = _DEVICE_CONSTS[device] = tuple(
            torch.from_numpy(a).to(device) for a in (PSI_CX, PSI_CY)
        )
    return c


def psi(p):
    """G2 twist endomorphism: psi(X, Y, Z) = (cx conj(X), cy conj(Y), conj(Z))."""
    X, Y, Z = p
    cx, cy = _psi_consts(X.device)
    S = X.shape[-1]
    return (
        tower.f2mul(tower.f2conj(X), tower.bcast(cx, S)),
        tower.f2mul(tower.f2conj(Y), tower.bcast(cy, S)),
        tower.f2conj(Z),
    )


def jac_eq(ops, p1, p2):
    """Exact equality with infinity handling (both infinity: True)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1 = ops.sqr(Z1)
    Z2Z2 = ops.sqr(Z2)
    ex = ops.eq_zero(ops.mul(X1, Z2Z2) - ops.mul(X2, Z1Z1))
    ey = ops.eq_zero(
        ops.mul(ops.mul(Y1, Z2), Z2Z2) - ops.mul(ops.mul(Y2, Z1), Z1Z1)
    )
    i1 = ops.is_zero_struct(Z1)
    i2 = ops.is_zero_struct(Z2)
    return torch.where(i1 | i2, i1 & i2, ex & ey)
