"""Batched G1 multi-scalar multiplication, lane-major, on the CUDA kernels.

Port of lighthouse_tpu/ops/lane/msm.py: per point a 2^w-entry multiples
table, then a Horner walk over 255/w windows sharing one ladder across the
batch, then the lane-halving exact sum tree. Every group op is one
kernel launch: a window doubling `jac_dbl_f1`, an exact add
`add_exact_f1` (the add, its collision check and the doubling it may
take, where the reference launches `jac_add_f1`, 2 `sqr`, 6 `mul`, 2
`canon_reduce` and a `jac_dbl_f1`); the reference's lax.scan loops are
Python loops here.

At a 4096-lane bucket one `msm_g1` makes 90 exact adds (14 table, 64
windows, 12 lane_sum levels) and 256 window doublings: 90 `add_exact_f1`
and 256 `jac_dbl_f1` launches (1,336 op by op).
"""

from __future__ import annotations

import numpy as np
import torch

from ...crypto.bls.params import R, lane_bucket
from . import fp, jacobian as J

WINDOW = 4
NDIGITS = -(-255 // WINDOW)  # 64


def scalars_to_digits(scalars) -> np.ndarray:
    """[n] ints -> [NDIGITS, n] int32 WINDOW-bit digits, MSB window FIRST
    (Horner order), lane-major. (Every scalar is reduced mod R < 2^255,
    so its 32 big-endian bytes hold exactly the 64 nibbles.)"""
    raw = np.frombuffer(
        b"".join((int(s) % R).to_bytes(32, "big") for s in scalars), np.uint8
    ).reshape(len(scalars), 32)
    nib = np.stack([raw >> 4, raw & 0xF], axis=-1).reshape(len(scalars), NDIGITS)
    return np.ascontiguousarray(nib.T.astype(np.int32))


def _msm_walk(xs, ys, zs, digits):
    """Shared windowed ladder: per-lane [scalar_i]P_i accumulators.
    digits: [NDIGITS, S] int64 on the points' device."""
    S = xs.shape[-1]
    base = (xs, ys, zs)
    ops = J.FP1

    # multiples table T[d] = [d]P, d < 2^WINDOW
    zero = tuple(ops.zeros((), S, xs.device) for _ in range(3))
    tail, acc = [], base
    for _ in range((1 << WINDOW) - 2):
        acc = J.add(ops, acc, base, exact=True)
        tail.append(acc)
    table = tuple(
        torch.stack([z, b, *(t[c] for t in tail)])  # [2^w, W, S]
        for c, (z, b) in enumerate(zip(zero, base))
    )

    # Horner over windows: acc = [2^w]acc + T[digit]
    acc = zero
    for d in range(NDIGITS):
        for _ in range(WINDOW):
            acc = J.double(ops, acc)
        idx = digits[d].reshape(1, 1, S).expand(1, fp.W, S)
        sel = tuple(torch.gather(t, 0, idx)[0] for t in table)
        acc = J.add(ops, acc, sel, exact=True)
    return acc


def _prepare(xyz, scalars):
    """Pad packed points [W, n] with structural infinity (Z = 0) and the
    scalars with 0 up to the power-of-two lane bucket (>= 128)."""
    n = xyz[0].shape[-1]
    npad = lane_bucket(n)
    xs, ys, zs = (torch.nn.functional.pad(c, (0, npad - n)) for c in xyz)
    sc = [s % R for s in scalars] + [0] * (npad - n)
    digits = torch.from_numpy(scalars_to_digits(sc)).to(xs.device, torch.int64)
    return xs, ys, zs, digits


def msm_g1_packed(xyz: tuple, scalars: list):
    """sum_i scalars[i] * P_i over points already packed as (X, Y, Z)
    [W, n] tensors (the device they lie on runs the MSM)."""
    xs, ys, zs, digits = _prepare(xyz, scalars)
    acc = _msm_walk(xs, ys, zs, digits)
    return J.unpack_g1(J.lane_sum(J.FP1, acc, xs.shape[-1]))[0]


def msm_g1(points: list, scalars: list, device=None):
    """sum_i scalars[i] * points[i]: affine points (or None) x python ints
    -> affine point or None. Runs on CUDA unless `device` says otherwise."""
    dev = fp.resolve_device(device)
    if not points:
        return None
    return msm_g1_packed(J.pack_g1(points, dev), scalars)


def msm_g1_groups(
    points: list, scalars: list, group_ids: list, n_groups: int, device=None
):
    """Segmented MSM: one shared ladder walk, then a per-group masked lane
    sum (one [G, W, S] tree). Returns an affine point (or None) per group."""
    dev = fp.resolve_device(device)
    if not points:
        return [None] * n_groups
    xs, ys, zs, digits = _prepare(J.pack_g1(points, dev), scalars)
    S = xs.shape[-1]
    acc = _msm_walk(xs, ys, zs, digits)
    gm = np.zeros((n_groups, S), dtype=bool)
    gm[np.asarray(group_ids), np.arange(len(group_ids))] = True
    gmask = torch.from_numpy(gm).to(dev)[:, None, :]
    # zeroing all coords makes non-members structural infinity (Z = 0)
    accG = tuple(torch.where(gmask, c[None], torch.zeros_like(c[None])) for c in acc)
    out = J.lane_sum(J.FP1, accG, S)
    return [J.unpack_g1(tuple(c[g] for c in out))[0] for g in range(n_groups)]
