"""Windowed exponentiation and the windowed scalar ladder, with CUDA kernels.

Port of lighthouse_tpu/ops/lane/chains.py:

- `pow_const_w4` / `inv` / `f2inv`: MSB-first 4-bit windowed Fermat
  chains (a 16-entry power table, then 4 squarings and one table product
  per window). The reference scans the static digits with a dynamic table
  index; here the loop runs in Python and indexes the table by the digit.
  The calls, and so the limbs, are the reference's. `inv` runs the whole
  chain for p - 2 in one kernel, `inv_w4` (csrc/inv.cu), whose plain
  body `_inv_w4_body` makes the same calls.
- `scalar_mul_w2`: the MSB-first 2-bit windowed ladder (G1 or G2) of the
  64-bit random-linear-combination scalars: acc <- [4]acc + T[digit] with
  the table {P, 2P, 3P}, one kernel per window (`g1_win_step` /
  `g2_win_step`, csrc/chains.cu: 2 doublings, the 3-way table select by
  the lane's digit, one branchless add, and the digit-0 pass-through of
  the doubled accumulator). `_win_step_body` is their plain PyTorch
  version. Both kernels are cooperative: their programs are traced from
  `_win_core_f1` / `_win_core_f2` (ops/lane/coop.py), and the digit and
  infinity selects (`_win_pick`, `_win_select`) sit in the kernels'
  epilogue.

Collision safety (the reference's argument): for a base in the r-torsion,
once acc is not infinity its scalar prefix k gives acc = [4k]P with
0 < 4k < 2^66 << r and 4k > 3 >= digit, so the branchless add never meets
the H == 0 doubling case; the infinity cases are structural inside the
add. A base outside the r-torsion can collide, but every caller gates the
verdict on the subgroup check.
"""

from __future__ import annotations

import torch

from ...crypto.bls.params import P
from . import fp, jacobian as J

W = fp.W


# ---------------------------------------------------------------- fp pow


def _pow_table(a):
    """[16, ..., W, S] powers a^0..a^15: 1 sqr + 3 stacked mul calls."""
    one = torch.from_numpy(fp.ONE).to(a.device)[:, None].expand(a.shape)
    a1 = fp.norm3_x(a, site="chains.pow_table.entry")
    a2 = fp.sqr(a1)
    p34 = fp.mul(torch.stack([a2, a2]), torch.stack([a1, a2]))
    a3, a4 = p34[0], p34[1]
    p58 = fp.mul(torch.stack([a4, a4, a4, a4]), torch.stack([a1, a2, a3, a4]))
    a5, a6, a7, a8 = (p58[k] for k in range(4))
    p915 = fp.mul(torch.stack([a8] * 7), torch.stack([a1, a2, a3, a4, a5, a6, a7]))
    return torch.stack(
        [one, a1, a2, a3, a4, a5, a6, a7, a8, *(p915[k] for k in range(7))]
    )


def window_digits(exponent: int) -> list:
    """The 4-bit windows of a static exponent, most significant first."""
    nw = (max(exponent.bit_length(), 1) + 3) // 4
    return [(exponent >> (4 * k)) & 15 for k in reversed(range(nw))]


def pow_const_w4(a, exponent: int):
    """a^e in Fp for a static e: MSB-first 4-bit windows from the table's
    1, each window 4 squarings and one product with the table entry."""
    table = _pow_table(a)
    acc = table[0]
    for d in window_digits(exponent):
        acc = fp.sqr(fp.sqr(fp.sqr(fp.sqr(acc))))
        acc = fp.mul(acc, table[d])
    return acc


def _inv_w4_body(folds, topf, a, one=None):
    """a^(p-2) by `pow_const_w4`'s windowed chain, as one body: the plain
    version of the `inv_w4` kernel, whose cooperative program
    (ops/lane/coop.py) is traced from it. It calls `fp._mul_body` and
    `fp._sqr_fn` in the order `pow_const_w4(a, P - 2)` calls the `mul`
    and `sqr` kernels (the table's square and its 3 stacked products,
    then 4 squares and a table product a window), so the limbs are
    `pow_const_w4`'s. `one`: table[0], the 1 the chain starts from (a
    row of the program; the kernel writes it)."""
    one = fp.one_like(a) if one is None else one
    a1 = fp._norm(a, topf, "chains.pow_table.entry")
    a2 = fp._sqr_fn(folds, topf, a1)
    p34 = fp._mul_body(torch.stack([a2, a2]), torch.stack([a1, a2]), folds, topf)
    a3, a4 = p34[0], p34[1]
    p58 = fp._mul_body(torch.stack([a4, a4, a4, a4]), torch.stack([a1, a2, a3, a4]),
                       folds, topf)
    a5, a6, a7, a8 = (p58[k] for k in range(4))
    p915 = fp._mul_body(torch.stack([a8] * 7), torch.stack([a1, a2, a3, a4, a5, a6, a7]),
                        folds, topf)
    table = [one, a1, a2, a3, a4, a5, a6, a7, a8, *(p915[k] for k in range(7))]
    acc = one
    for d in window_digits(P - 2):
        for _ in range(4):
            acc = fp._sqr_fn(folds, topf, acc)
        acc = fp._mul_body(acc, table[d], folds, topf)
    return acc


# one launch per inversion: 385 squares and 109 products on a warp per
# lane element (csrc/inv.cu)
inv_w4 = fp.KernelOp(_inv_w4_body, "inv_w4", "lh_inv_w4")


def inv(a):
    """a^(p-2): windowed Fermat inversion (0 maps to 0), `pow_const_w4`'s
    chain in one kernel (`inv_w4`)."""
    return inv_w4(a)


def f2inv(a):
    """1/(a0 + a1 u) through one windowed Fp inversion of the norm."""
    a = fp.norm3_x(a, site="chains.f2inv.entry")
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    sq = fp.mul(torch.stack([a0, a1], -3), torch.stack([a0, a1], -3))
    norm = sq[..., 0, :, :] + sq[..., 1, :, :]
    ninv = inv(norm)
    return fp.mul(torch.stack([a0, -a1], -3), ninv[..., None, :, :])


# ---------------------------------------------------------------- ladder


def _win_pick(dig, T1, T2, T3, f2):
    """The table entry of each lane's digit (dig [..., 1, S] int32): T3 for
    3, T2 for 2, T1 for 0 and 1."""
    d = dig[..., 0, :]
    nc = 2 if f2 else 1
    return tuple(J._wh(d == 3, c, J._wh(d == 2, b, a, nc), nc) for a, b, c in zip(T1, T2, T3))


def _win_core(folds, topf, Xa, Ya, Za, Xe, Ye, Ze, f2):
    """The window step's arithmetic on the accumulator and the table entry
    E: [4]acc by two doublings, then [4]acc + E by add-2007-bl without its
    selection. Returns the 3 coordinates of [4]acc, then those of the sum."""
    acc4 = J._dbl_body(folds, topf, Xa, Ya, Za, f2=f2)
    acc4 = J._dbl_body(folds, topf, *acc4, f2=f2)
    return (*acc4, *J._add_core(folds, topf, *acc4, Xe, Ye, Ze, f2=f2))


def _win_select(dig, acc4, entry, total, f2):
    """The window step's result: [4]acc where the digit is 0, else the
    add's structural-infinity selection of ([4]acc, E, the sum)."""
    nc = 2 if f2 else 1
    keep = dig[..., 0, :] == 0
    added = J._add_select(acc4, entry, total, f2=f2)
    return tuple(J._wh(keep, a, o, nc) for a, o in zip(acc4, added))


def _win_step_body(
    folds, topf, Xa, Ya, Za, X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, dig, f2
):
    """acc <- [4]acc + T[digit]: the 3-way table select, 2 doublings, one
    branchless add (on every lane), and the digit-0 pass-through of the
    doubled accumulator. dig [..., 1, S] int32 in 0..3."""
    entry = _win_pick(dig, (X1, Y1, Z1), (X2, Y2, Z2), (X3, Y3, Z3), f2)
    out = _win_core(folds, topf, Xa, Ya, Za, *entry, f2=f2)
    return _win_select(dig, out[:3], entry, out[3:], f2)


def _win_core_f1(folds, topf, *args):
    return _win_core(folds, topf, *args, f2=False)


def _win_core_f2(folds, topf, *args):
    return _win_core(folds, topf, *args, f2=True)


def _win_step_f1_body(folds, topf, *args):
    return _win_step_body(folds, topf, *args, f2=False)


def _win_step_f2_body(folds, topf, *args):
    return _win_step_body(folds, topf, *args, f2=True)


_win_step = {
    "fp": fp.KernelOp(_win_step_f1_body, "g1_win_step", "lh_g1_win_step"),
    "fp2": fp.KernelOp(_win_step_f2_body, "g2_win_step", "lh_g2_win_step"),
}


def scalar_mul_w2(ops, base, bits):
    """[k]base (ops = jacobian.FP1 / FP2) for per-lane 64-bit scalars;
    bits [64, S] LSB-first int32 (the jacobian.scalars_to_bits layout).
    MSB-first 2-bit windowed Horner with the table {P, 2P, 3P}, from the
    infinity accumulator."""
    nbits = bits.shape[0]
    assert nbits % 2 == 0
    t1 = base
    t2 = J.double(ops, t1)
    t3 = J.add(ops, t2, t1, exact=True)
    digs = (bits[0::2] + 2 * bits[1::2]).flip(0)    # [nbits/2, S] MSB-first
    acc = J.infinity_like(ops, base)
    kern = _win_step[ops.name]
    for k in range(digs.shape[0]):
        acc = kern(*acc, *t1, *t2, *t3, digs[k : k + 1])
    return acc
