"""Hash-to-curve for BLS12-381 G2 (ciphersuite BLS12381G2_XMD:SHA-256_SSWU_RO_),
on the host: the port's copy of lighthouse_tpu/crypto/bls/hash_to_curve.py
over its own `fields`/`curve`.

RFC 9380 construction: expand_message_xmd(SHA-256) -> hash_to_field(Fp2,
m=2) -> simplified SWU on the isogenous curve E2' -> 3-isogeny to E2 ->
Budroni-Pintore cofactor clearing. `hash_to_field_fp2` feeds the device map
(ops/lane/htc.py); `hash_to_g2` is the oracle the device map is held to,
and the CPU control backend's map.
"""

from __future__ import annotations

import functools
import hashlib

from . import _g2_isogeny_consts as ISO
from . import curve as C
from . import fields as F
from . import params
from .params import P

# SSWU parameters for E2': y^2 = x^3 + A'x + B' (RFC 9380 §8.8.2).
A_PRIME = (0, 240)
B_PRIME = (1012, 1012)
Z = (-2 % P, -1 % P)  # Z = -(2 + u)

_SHA256_BLOCK = 64
_L = 64  # bytes per field element draw: ceil((381 + 128) / 8)


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd with SHA-256."""
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (len_in_bytes + 31) // 32
    if ell > 255:
        raise ValueError("len_in_bytes too large")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * _SHA256_BLOCK
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    bvals = [hashlib.sha256(b0 + b"\x01" + dst_prime).digest()]
    b0_int = int.from_bytes(b0, "big")
    for i in range(2, ell + 1):
        # strxor through one int xor
        mixed = (b0_int ^ int.from_bytes(bvals[-1], "big")).to_bytes(32, "big")
        bvals.append(hashlib.sha256(mixed + bytes([i]) + dst_prime).digest())
    return b"".join(bvals)[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, count: int, dst: bytes = params.DST):
    """RFC 9380 §5.2: draw `count` Fp2 elements from msg."""
    out = expand_message_xmd(msg, dst, count * 2 * _L)
    els = []
    for i in range(count):
        c0 = int.from_bytes(out[(2 * i) * _L : (2 * i + 1) * _L], "big") % P
        c1 = int.from_bytes(out[(2 * i + 1) * _L : (2 * i + 2) * _L], "big") % P
        els.append((c0, c1))
    return els


def sgn0(a) -> int:
    """RFC 9380 §4.1 sgn0 for Fp2."""
    s0 = a[0] % 2
    z0 = a[0] == 0
    s1 = a[1] % 2
    return s0 | (int(z0) & s1)


def _is_square(a) -> bool:
    if a == F.F2_ZERO:
        return True
    return F.f2pow(a, (P * P - 1) // 2) == F.F2_ONE


def _g_prime(x):
    """g'(x) = x^3 + A'x + B' on E2'."""
    return F.f2add(F.f2add(F.f2mul(F.f2sqr(x), x), F.f2mul(A_PRIME, x)), B_PRIME)


def map_to_curve_sswu(u):
    """Simplified SWU (RFC 9380 §6.6.2) onto E2'(Fp2)."""
    u2 = F.f2sqr(u)
    zu2 = F.f2mul(Z, u2)
    tv1 = F.f2add(F.f2sqr(zu2), zu2)  # Z^2 u^4 + Z u^2
    if tv1 == F.F2_ZERO:
        x1 = F.f2mul(B_PRIME, F.f2inv(F.f2mul(Z, A_PRIME)))
    else:
        # x1 = (-B/A) * (1 + 1/tv1)
        x1 = F.f2mul(
            F.f2mul(F.f2neg(B_PRIME), F.f2inv(A_PRIME)),
            F.f2add(F.F2_ONE, F.f2inv(tv1)),
        )
    gx1 = _g_prime(x1)
    if _is_square(gx1):
        x, y = x1, F.f2sqrt(gx1)
    else:
        x2 = F.f2mul(zu2, x1)
        x, y = x2, F.f2sqrt(_g_prime(x2))
    if sgn0(u) != sgn0(y):
        y = F.f2neg(y)
    return (x, y)


def _eval_poly(coeffs, x):
    acc = F.F2_ZERO
    for c in reversed(coeffs):
        acc = F.f2add(F.f2mul(acc, x), c)
    return acc


def iso_map(pt):
    """The 3-isogeny E2' -> E2 (rational maps from _g2_isogeny_consts)."""
    if pt is None:
        return None
    x, y = pt
    xd = _eval_poly(ISO.XDEN, x)
    yd = _eval_poly(ISO.YDEN, x)
    if xd == F.F2_ZERO or yd == F.F2_ZERO:
        return None  # x is the kernel abscissa: the image is the identity
    xx = F.f2mul(_eval_poly(ISO.XNUM, x), F.f2inv(xd))
    yy = F.f2mul(y, F.f2mul(_eval_poly(ISO.YNUM, x), F.f2inv(yd)))
    return (xx, yy)


@functools.lru_cache(maxsize=512)
def hash_to_g2(msg: bytes, dst: bytes = params.DST):
    """Full hash_to_curve: msg -> point in G2 (the r-torsion of E2).

    Memoized: a committee's attesters sign the same message, so the map
    runs once per distinct message."""
    u0, u1 = hash_to_field_fp2(bytes(msg), 2, bytes(dst))
    q0 = iso_map(map_to_curve_sswu(u0))
    q1 = iso_map(map_to_curve_sswu(u1))
    return C.g2_clear_cofactor(C.g2_add(q0, q1))
