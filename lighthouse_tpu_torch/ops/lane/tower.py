"""Lane-major Fp2/Fp6/Fp12 tower in PyTorch, with hand-written CUDA kernels.

Port of lighthouse_tpu/ops/lane/tower.py. Tower (as crypto/bls/fields.py):
    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = 1 + u
    Fp12 = Fp6[w] / (w^2 - v)

Layouts (trailing dims; leading stack dims broadcast):
    Fp2  : [..., 2, W, S]
    Fp6  : [..., 3, 2, W, S]
    Fp12 : [..., 2, 3, 2, W, S]

The bodies below are the plain PyTorch versions of the kernels, operation
for operation the reference's (the same Karatsuba stacks, the same lazy
sums, `reduce_light` where it puts it), so the limb-bounds certificate
covers them and the CPU tests compare limbs exactly. `f2mul`, `f2sqr`,
`f6mul`, `f12mul`, `f12sqr` and `f12mul_034` are KernelOps (csrc/tower.cu);
the bodies of the last two also run inside the Miller kernels
(csrc/miller.cu), fused into one doubling or addition iteration.

Laziness contract (the reference's): entries re-normalize, f2/f6 outputs
are standard; f12mul outputs <=3-unit and f12sqr <=4-unit lazy sums.
"""

from __future__ import annotations

import numpy as np
import torch

from ...crypto.bls import fields as FF
from ...crypto.bls.params import P, XI
from . import fp

W = fp.W


# ---------------------------------------------------------------- host codecs


def f2_pack(t) -> np.ndarray:
    """(a0, a1) ints -> [2, W, 1] limbs (lane dim of 1, broadcastable)."""
    return np.stack([fp.to_limbs(t[0]), fp.to_limbs(t[1])])[..., None].astype(np.int32)


def f2_pack_many(ts) -> np.ndarray:
    """list of (a0, a1) -> [2, W, n]."""
    return np.stack(
        [fp.pack([t[0] for t in ts]), fp.pack([t[1] for t in ts])]
    ).astype(np.int32)


def f6_pack(t) -> np.ndarray:
    return np.stack([f2_pack(c) for c in t])


def f12_pack(t) -> np.ndarray:
    return np.stack([f6_pack(c) for c in t])


def f2_unpack(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return fp.from_limbs(a[..., 0, :, 0]), fp.from_limbs(a[..., 1, :, 0])


def f12_unpack_one(a):
    """[2, 3, 2, W, 1] -> nested tuple of ints."""
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return tuple(
        tuple(
            (fp.from_limbs(a[j, i, 0, :, 0]), fp.from_limbs(a[j, i, 1, :, 0]))
            for i in range(3)
        )
        for j in range(2)
    )


F2_ONE = f2_pack(FF.F2_ONE)
F12_ONE = f12_pack(FF.F12_ONE)


def bcast(const, lanes: int):
    """Broadcast a packed [..., W, 1] constant along the lane axis."""
    return const.expand(*const.shape[:-1], lanes)


# ------------------------------------------------------------ plain bodies
# All bodies take (folds, topf) first and operate on [..., comp, W, S].


def _c(a, k):
    """Component k along axis -3 (the Fp2 axis of [..., 2, W, S])."""
    return a[..., k, :, :]


def _c2(a, k):
    return a[..., k, :, :, :]


def _c3(a, k):
    return a[..., k, :, :, :, :]


def _f2mul_body(folds, topf, a, b):
    """Karatsuba 3-mul; standard output. a, b [..., 2, W, S] lazy <=3u."""
    a0, a1 = _c(a, 0), _c(a, 1)
    b0, b1 = _c(b, 0), _c(b, 1)
    aa = torch.stack([a0, a1, a0 + a1], -3)
    bb = torch.stack([b0, b1, b0 + b1], -3)
    t = fp._mul_body(aa, bb, folds, topf)
    c0 = _c(t, 0) - _c(t, 1)
    c1 = _c(t, 2) - _c(t, 0) - _c(t, 1)
    return fp._reduce_light_body(torch.stack([c0, c1], -3), folds, topf)


def _f2sqr_body(folds, topf, a):
    a0, a1 = _c(a, 0), _c(a, 1)
    aa = torch.stack([a0 + a1, a0], -3)
    bb = torch.stack([a0 - a1, a1 + a1], -3)
    return fp._mul_body(aa, bb, folds, topf)


def f2mul_xi(a):
    """(1+u)(a0 + a1 u) = (a0 - a1, a0 + a1). Lazy 2x; plain adds."""
    a0, a1 = _c(a, 0), _c(a, 1)
    return torch.stack([a0 - a1, a0 + a1], -3)


def _f6mul_body(folds, topf, a, b):
    """6 stacked f2muls + recombination; standard output."""
    a0, a1, a2 = _c2(a, 0), _c2(a, 1), _c2(a, 2)
    b0, b1, b2 = _c2(b, 0), _c2(b, 1), _c2(b, 2)
    aa = torch.stack([a0, a1, a2, a0 + a1, a0 + a2, a1 + a2], -4)
    bb = torch.stack([b0, b1, b2, b0 + b1, b0 + b2, b1 + b2], -4)
    t = _f2mul_body(folds, topf, aa, bb)
    t0, t1, t2 = _c2(t, 0), _c2(t, 1), _c2(t, 2)
    u01, u02, u12 = _c2(t, 3), _c2(t, 4), _c2(t, 5)
    c0 = t0 + f2mul_xi(u12 - t1 - t2)
    c1 = u01 - t0 - t1 + f2mul_xi(t2)
    c2 = u02 - t0 - t2 + t1
    return fp._reduce_light_body(torch.stack([c0, c1, c2], -4), folds, topf)


def f6mul_by_v(a):
    return torch.stack([f2mul_xi(_c2(a, 2)), _c2(a, 0), _c2(a, 1)], -4)


def _f12mul_body(folds, topf, a, b):
    """3 stacked f6muls; <=3-unit lazy output."""
    a0, a1 = _c3(a, 0), _c3(a, 1)
    b0, b1 = _c3(b, 0), _c3(b, 1)
    aa = torch.stack([a0, a1, a0 + a1], -5)
    bb = torch.stack([b0, b1, b0 + b1], -5)
    t = _f6mul_body(folds, topf, aa, bb)
    t0, t1, t2 = _c3(t, 0), _c3(t, 1), _c3(t, 2)
    c0 = t0 + f6mul_by_v(t1)
    c1 = t2 - t0 - t1
    return torch.stack([c0, c1], -5)


def _f12sqr_body(folds, topf, a):
    a0, a1 = _c3(a, 0), _c3(a, 1)
    aa = torch.stack([a0 + a1, a0], -5)
    bb = torch.stack([a0 + f6mul_by_v(a1), a1], -5)
    t = _f6mul_body(folds, topf, aa, bb)
    m, n = _c3(t, 0), _c3(t, 1)
    c0 = m - n - f6mul_by_v(n)
    c1 = n + n
    return torch.stack([c0, c1], -5)


def _f12mul_034_body(folds, topf, f, c0, c1, c4):
    """f * (c0 + c1 v + c4 v w): the sparse line product, 13 f2 products
    (5 + 3 + 5) against a general f12mul's 18. f lazy <=4u; c0/c1/c4
    [..., 2, W, S] standard. Output <=3-unit lazy."""
    g0, g1 = _c3(f, 0), _c3(f, 1)
    x0, x1, x2 = _c2(g0, 0), _c2(g0, 1), _c2(g0, 2)
    y0, y1, y2 = _c2(g1, 0), _c2(g1, 1), _c2(g1, 2)
    d = c1 + c4                       # (L0+L1) middle coefficient
    aa = torch.stack(
        [x0, x1, x0 + x1, x2, x2,          # t0 = g0 * (c0, c1, 0)
         y0, y1, y2,                        # t1 = g1 * (0, c4, 0)
         x0 + y0, x1 + y1, (x0 + y0) + (x1 + y1), x2 + y2, x2 + y2],
        -4,
    )
    bb = torch.stack(
        [c0, c1, c0 + c1, c0, c1,
         c4, c4, c4,
         c0, d, c0 + d, c0, d],
        -4,
    )
    t = _f2mul_body(folds, topf, aa, bb)
    m00, m11, m01k, m20, m21 = (_c2(t, i) for i in range(5))
    n0, n1, n2 = (_c2(t, i) for i in range(5, 8))
    s00, s11, s01k, s20, s21 = (_c2(t, i) for i in range(8, 13))
    t0 = torch.stack([m00 + f2mul_xi(m21), m01k - m00 - m11, m11 + m20], -4)
    t1 = torch.stack([f2mul_xi(n2), n0, n1], -4)            # g1 * (0, c4, 0)
    ts = torch.stack([s00 + f2mul_xi(s21), s01k - s00 - s11, s11 + s20], -4)
    r0 = t0 + f6mul_by_v(t1)
    r1 = ts - t0 - t1
    return torch.stack([r0, r1], -5)


# ------------------------------------------------------------ kernels

f2mul = fp.KernelOp(_f2mul_body, "f2mul", "lh_f2mul")
f2sqr = fp.KernelOp(_f2sqr_body, "f2sqr", "lh_f2sqr")
f6mul = fp.KernelOp(_f6mul_body, "f6mul", "lh_f6mul")
f12mul = fp.KernelOp(_f12mul_body, "f12mul", "lh_f12mul")
f12sqr = fp.KernelOp(_f12sqr_body, "f12sqr", "lh_f12sqr")
f12mul_034 = fp.KernelOp(_f12mul_034_body, "f12mul_034", "lh_f12mul_034")


# ------------------------------------------------------------ glue

_CONJ_SIGN = np.array([1, -1], dtype=np.int32)[:, None, None]


def f2conj(a):
    return a * torch.from_numpy(_CONJ_SIGN).to(a.device)


def f2inv(a):
    """1/(a0 + a1 u) = (a0 - a1 u)/(a0^2 + a1^2). One Fermat inversion."""
    a = fp.norm3_x(a, site="tower.f2inv.entry")
    a0, a1 = _c(a, 0), _c(a, 1)
    sq = fp.mul(torch.stack([a0, a1], -3), torch.stack([a0, a1], -3))
    norm = _c(sq, 0) + _c(sq, 1)
    ninv = fp.inv(norm)
    return fp.mul(torch.stack([a0, -a1], -3), ninv[..., None, :, :])


def f2_eq(a, b):
    return fp.eq(a, b).all(dim=-2)


def f2_eq_zero(a):
    return fp.eq_zero(a).all(dim=-2)


def f6sqr(a):
    return f6mul(a, a)


def f6neg(a):
    return -a


def f6inv(a):
    a = fp.norm3_x(a, site="tower.f6inv.entry")
    a0, a1, a2 = _c2(a, 0), _c2(a, 1), _c2(a, 2)
    sq = f2sqr(torch.stack([a0, a2, a1], -4))
    s0, s2, s1 = _c2(sq, 0), _c2(sq, 1), _c2(sq, 2)
    pr = f2mul(torch.stack([a1, a0, a0], -4), torch.stack([a2, a1, a2], -4))
    a1a2, a0a1, a0a2 = _c2(pr, 0), _c2(pr, 1), _c2(pr, 2)
    c0 = s0 - f2mul_xi(a1a2)
    c1 = f2mul_xi(s2) - a0a1
    c2 = s1 - a0a2
    tt = f2mul(torch.stack([a0, a2, a1], -4), torch.stack([c0, c1, c2], -4))
    t = _c2(tt, 0) + f2mul_xi(_c2(tt, 1) + _c2(tt, 2))
    ti = f2inv(t)
    return f2mul(torch.stack([c0, c1, c2], -4), ti[..., None, :, :, :])


def f12conj(a):
    return torch.cat([a[..., :1, :, :, :, :], -a[..., 1:, :, :, :, :]], -5)


def f12inv(a):
    t = f6inv(fp.reduce_light(f6sqr(_c3(a, 0)) - f6mul_by_v(f6sqr(_c3(a, 1)))))
    c0 = f6mul(_c3(a, 0), t)
    c1 = f6neg(f6mul(_c3(a, 1), t))
    return torch.stack([c0, c1], -5)


def f12_eq(a, b):
    return fp.eq(a, b).all(dim=-2).all(dim=-2).all(dim=-2)


def f12_eq_one(a):
    return f12_eq(a, bcast(consts(a.device)["f12_one"], a.shape[-1]))


# ---------------------------------------------------------------- Frobenius

_G1 = [FF.f2pow(XI, k * ((P - 1) // 6)) for k in range(6)]
_G2 = [FF.f2mul(g, FF.f2conj(g)) for g in _G1]
_G3 = [FF.f2mul(_G1[k], _G2[k]) for k in range(6)]

assert all(g[1] == 0 for g in _G2), "gamma2 must be real"


def _coeff_const(gammas) -> np.ndarray:
    arr = np.zeros((2, 3, 2, W, 1), dtype=np.int32)
    for j in range(2):
        for i in range(3):
            arr[j, i] = f2_pack(gammas[2 * i + j])
    return arr


_G1C = _coeff_const(_G1)
_G3C = _coeff_const(_G3)
_G2C = np.ascontiguousarray(
    np.stack(
        [np.stack([fp.to_limbs(_G2[2 * i + j][0]) for i in range(3)]) for j in range(2)]
    )[:, :, None, :, None]
)  # [2, 3, 1, W, 1]: broadcasts over the Fp2 component axis

_DEVICE_CONSTS: dict = {}


def consts(device) -> dict:
    """The tower's constants as tensors on `device` (made once per device):
    f2_one, f12_one, g1c, g2c, g3c."""
    device = torch.device(device)
    c = _DEVICE_CONSTS.get(device)
    if c is None:
        c = {
            name: torch.from_numpy(arr).to(device)
            for name, arr in (
                ("f2_one", F2_ONE), ("f12_one", F12_ONE),
                ("g1c", _G1C), ("g2c", _G2C), ("g3c", _G3C),
            )
        }
        _DEVICE_CONSTS[device] = c
    return c


def frob1(a):
    return f2mul(f2conj(a), bcast(consts(a.device)["g1c"], a.shape[-1]))


def frob2(a):
    return fp.mul(a, bcast(consts(a.device)["g2c"], a.shape[-1]))


def frob3(a):
    return f2mul(f2conj(a), bcast(consts(a.device)["g3c"], a.shape[-1]))
