"""Lane-major batched Fp arithmetic in PyTorch, with hand-written CUDA kernels.

Port of lighthouse_tpu/ops/lane/fp.py. Same layout and number theory:
an element batch is an int32 tensor [stack..., W=36, S] (limbs on the
second-last axis, the batch S on the last), signed lazy 11-bit limbs, and
the constant-matrix fold reduction of ops/fp.py. The carry schedule
(`_SCHED`, `_OPEN_SITES`) is copied literally, so the reference's limb-bounds
certificate (tests/budgets/limb_bounds.json) covers these bodies too: no
int32 product or sum wraps at these depths.

Every body below is the PLAIN PyTorch version of a kernel. `KernelOp`
(the counterpart of the reference's `kernel_op` launcher) wraps it: on a
CPU tensor it runs the body, on a CUDA tensor it launches the hand-written
kernel (csrc/, built by ops/lane/kernels.py) and counts the launch in
`LAUNCHES`. There is no fallback from a CUDA tensor to the body.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from ...crypto.bls.params import P
from .. import fp as _base
from . import kernels

B = _base.B
W = _base.W
MASK = _base.MASK
CONVW = _base.CONVW
FOLD_AT = _base.FOLD_AT

to_limbs = _base.to_limbs
from_limbs = _base.from_limbs

ZERO = _base.ZERO
ONE = _base.ONE

# ---------------------------------------------------------------- constants
#   FOLDS [W, 41] = [full | 2 | 1] fold matrices, transposed to limb-major
#   TOPFM [3, CONVW] = topfold vectors for carry widths 73, 37, 36
# C order: the CUDA libraries copy these buffers by pointer (the
# concatenation of transposes would otherwise come out in Fortran order)
FOLDS_NP = np.ascontiguousarray(
    np.concatenate([_base.FOLD_FULL.T, _base.FOLD_2.T, _base.FOLD_1.T], axis=1),
    dtype=np.int32,
)
TOPFM_NP = np.zeros((3, CONVW), np.int32)
TOPFM_NP[0, :CONVW] = _base._topfold(CONVW)
TOPFM_NP[1, :37] = _base._topfold(37)
TOPFM_NP[2, :W] = _base._topfold(W)
_TROW = {CONVW: 0, 37: 1, W: 2}

KP_37 = _base.KP_37
PK_LADDER = _base.PK_LADDER
_LADDER_ROUNDS = _base._LADDER_ROUNDS

_DEVICE_CONSTS: dict = {}


def consts(device) -> dict:
    """The constant tables as tensors on `device` (made once per device)."""
    device = torch.device(device)
    c = _DEVICE_CONSTS.get(device)
    if c is None:
        c = {
            "folds": torch.from_numpy(FOLDS_NP).to(device),
            "topf": torch.from_numpy(TOPFM_NP).to(device),
            "kp37": torch.from_numpy(KP_37).to(device)[:, None],
            "pk_ladder": torch.from_numpy(PK_LADDER).to(device)[:, :, None],
        }
        _DEVICE_CONSTS[device] = c
    return c


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA where there is none raises; nothing carries
    on on the CPU in its place."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch sees no GPU; "
            "pass device='cpu' to run the plain PyTorch bodies"
        )
    return dev


# ---------------------------------------------------------------- host codecs


def pack(ints) -> np.ndarray:
    """Iterable of python ints -> [W, n] int32 canonical limbs (lane-major)."""
    vals = [int(i) % P for i in ints]
    raw = np.frombuffer(
        b"".join(v.to_bytes(50, "little") for v in vals), np.uint8
    ).reshape(len(vals), 50)
    bits = np.unpackbits(raw, axis=1, bitorder="little")[:, : W * B]
    weights = (1 << np.arange(B)).astype(np.int32)
    limbs = bits.reshape(len(vals), W, B).astype(np.int32) @ weights
    return np.ascontiguousarray(limbs.T.astype(np.int32))


def unpack(arr) -> list:
    """[..., W, S] -> flat list of python ints (host, boundary only)."""
    a = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    flat = a.reshape(-1, *a.shape[-2:])
    return [from_limbs(blk[:, s]) for blk in flat for s in range(blk.shape[-1])]


# ---------------------------------------------------------------- core bodies
# Plain PyTorch over [..., W|CONVW, S]; the CPU path and the yardstick the
# CUDA kernels are held to on the card.


def _pad_rows(x, before: int, after: int):
    return F.pad(x, (0, 0, before, after))


# 0-dim operands: cheaper per op than Python scalars, valid on any device
_B_T = torch.tensor(B, dtype=torch.int32)
_MASK_T = torch.tensor(MASK, dtype=torch.int32)


def _norm1(x, topf):
    """One carry pass along the limb axis; top carry folded back mod p."""
    w = x.shape[-2]
    hi = x >> _B_T
    out = x & _MASK_T
    out[..., 1:, :] += hi[..., :-1, :]
    return out.addcmul_(hi[..., -1:, :], topf[_TROW[w], :w, None])


def _norm1_open(x, topf):
    """One VALUE-PRESERVING carry pass: the top limb re-absorbs its own
    carry (lo_top + 2^B * carry_top == top) instead of folding it mod p,
    so the encoded value is exactly preserved (what canonical()'s ripple
    window needs). `topf` is accepted and ignored (uniform signature)."""
    del topf
    hi = x >> _B_T
    out = x & _MASK_T
    out[..., 1:, :] += hi[..., :-1, :]
    out[..., -1, :] += hi[..., -1, :] << _B_T
    return out


# Carry-pass schedule: per-site norm depths, copied literally from the
# reference (lighthouse_tpu/ops/lane/fp.py `_SCHED`), whose limb-bounds
# certificate proves them sufficient. tests/test_torch_fp.py pins the two
# dicts equal; csrc/fp_lane.cuh carries the same depths as constants.
_SCHED = {
    "mul.entry_a": 2,
    "mul.entry_b": 2,
    "mul.wide": 2,
    "mul.fold37": 0,
    "mul.fold36": 0,
    "mul.fold35": 1,
    "sqr.entry": 1,
    "rl.entry": 0,
    "rl.fold_a": 0,
    "rl.fold_b": 1,
    "norm3.kernel": 2,
    "normalize": 2,
    "canon.entry": 0,
    "canon.fold_a": 0,
    "canon.fold_b": 1,
    "canon.fold_c": 1,
    "canon.fold_d": 0,
    "fp.pow_const.entry": 0,
    "tower.f2inv.entry": 0,
    "tower.f6inv.entry": 0,
    "chains.pow_table.entry": 0,
    "chains.f2inv.entry": 0,
    "htc.ratio_chain.entry": 0,
    "pairing.cyc_mul": 0,
}

# value-preserving (`_norm1_open`) sites: canonical()'s pre-ripple chain
_OPEN_SITES = frozenset({
    "canon.entry", "canon.fold_a", "canon.fold_b",
    "canon.fold_c", "canon.fold_d",
})


def _norm(x, topf, site: str):
    """Carry normalization at the certified depth of schedule `site`
    (unknown sites run the full 3 passes)."""
    body = _norm1_open if site in _OPEN_SITES else _norm1
    for _ in range(_SCHED.get(site, 3)):
        x = body(x, topf)
    return x


def _pad_limbs(x, width):
    return _pad_rows(x, 0, width - x.shape[-2])


def _fold(x, mt):
    """Fold limbs [FOLD_AT:] down via constant matrix mt [W, n_hi]."""
    hi = x[..., FOLD_AT:, :]
    if hi.shape[-2] == 1:
        acc = hi * mt
    else:
        acc = (mt[:, :, None] * hi[..., None, :, :]).sum(-2, dtype=torch.int32)
    acc[..., :FOLD_AT, :] += x[..., :FOLD_AT, :]
    return acc


def _conv(a, b):
    """Schoolbook limb product -> [..., CONVW, S]: acc[i+j] += a[i]*b[j]
    (limbs 71 and 72 stay 0), the reference's roll-based `_conv`.

    The outer product P[i, j] is written into 73 zeroed columns; read with
    a row stride of 72 instead of 73, row i starts i columns early, so
    summing the rows adds exactly the anti-diagonals i + j = k (the early
    reads land in the previous row's zero columns)."""
    a, b = torch.broadcast_tensors(a, b)
    S = a.shape[-1]
    lead = a.shape[:-2]
    buf = a.new_empty((*lead, W, CONVW, S))
    buf[..., W:, :] = 0
    torch.mul(a[..., :, None, :], b[..., None, :, :], out=buf[..., :W, :])
    skew = buf.as_strided(
        (*lead, W, CONVW, S), (*buf.stride()[:-3], (CONVW - 1) * S, S, 1)
    )
    return skew.sum(-3, dtype=torch.int32)


def _mul_body(a, b, folds, topf, norm_a=True, norm_b=True):
    if norm_a:
        a = _norm(a, topf, "mul.entry_a")
    if norm_b:
        b = _norm(b, topf, "mul.entry_b")
    wide = _norm(_conv(a, b), topf, "mul.wide")
    x = _norm(_pad_limbs(_fold(wide, folds[:, :38]), 37), topf, "mul.fold37")
    x = _norm(_fold(x, folds[:, 38:40]), topf, "mul.fold36")
    x = _norm(_fold(x, folds[:, 40:41]), topf, "mul.fold35")
    return x


def _reduce_light_body(x, folds, topf):
    x = _norm(x, topf, "rl.entry")
    x = _norm(_fold(x, folds[:, 40:41]), topf, "rl.fold_a")
    x = _norm(_fold(x, folds[:, 40:41]), topf, "rl.fold_b")
    return x


def _canon_reduce_body(x, folds, topf):
    """canonical()'s pre-ripple reduction: value-preserving (top-open)
    carry passes + four mod-p fold rounds."""
    x = _norm(x, topf, "canon.entry")
    x = _norm(_fold(x, folds[:, 40:41]), topf, "canon.fold_a")
    x = _norm(_fold(x, folds[:, 40:41]), topf, "canon.fold_b")
    x = _norm(_fold(x, folds[:, 40:41]), topf, "canon.fold_c")
    x = _norm(_fold(x, folds[:, 40:41]), topf, "canon.fold_d")
    return x


# ---------------------------------------------------------------- launcher

# kernel launches per op name, counted where the CUDA kernel is launched
LAUNCHES: Counter = Counter()
# plain-body calls made on CUDA tensors (only a comparison should make any)
PLAIN_CUDA_CALLS: Counter = Counter()


def reset_counts() -> None:
    LAUNCHES.clear()
    PLAIN_CUDA_CALLS.clear()


class KernelOp:
    """A lane-major op with a hand-written CUDA kernel and its plain body.

    fn(folds, topf, *arrays) is the plain PyTorch version; `symbol` names
    the kernel's C entry in kernels.py. A call on CPU tensors runs `fn`;
    a call on CUDA tensors launches the kernel (or raises)."""

    def __init__(self, fn, name: str, symbol: str):
        self.fn = fn
        self.name = name
        self.symbol = symbol
        self.n_out = len(kernels.ENTRIES[symbol][2])

    def plain(self, *arrays):
        dev = arrays[0].device
        if dev.type == "cuda":
            PLAIN_CUDA_CALLS[self.name] += 1
        c = consts(dev)
        return self.fn(c["folds"], c["topf"], *arrays)

    def __call__(self, *arrays):
        devs = {a.device for a in arrays}
        if len(devs) != 1:
            raise ValueError(f"{self.name}: operands on several devices {devs}")
        dev = devs.pop()
        if dev.type == "cpu":
            return self.plain(*arrays)
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for device {dev}")
        outs = kernels.launch(self.symbol, arrays)
        LAUNCHES[self.name] += 1
        return outs[0] if self.n_out == 1 else tuple(outs)


def _mul_fn(folds, topf, a, b):
    return _mul_body(a, b, folds, topf)


def _sqr_fn(folds, topf, a):
    a2 = _norm(a, topf, "sqr.entry")
    return _mul_body(a2, a2, folds, topf, norm_a=False, norm_b=False)


def _reduce_light_fn(folds, topf, x):
    return _reduce_light_body(x, folds, topf)


def _norm3_fn(folds, topf, x):
    return _norm(x, topf, "norm3.kernel")


def _canon_reduce_fn(folds, topf, x):
    return _canon_reduce_body(x, folds, topf)


mul = KernelOp(_mul_fn, "mul", "lh_fp_mul")
sqr = KernelOp(_sqr_fn, "sqr", "lh_fp_sqr")
reduce_light = KernelOp(_reduce_light_fn, "reduce_light", "lh_fp_reduce_light")
# the public carry reset: lazy limbs back to standard at the norm3.kernel depth
norm3 = KernelOp(_norm3_fn, "norm3", "lh_fp_norm3")
canon_reduce = KernelOp(_canon_reduce_fn, "canon_reduce", "lh_fp_canon_reduce")


def norm3_x(x, site: str = None):
    """Carry normalization in plain torch (no kernel) for cheap glue:
    `site` names a certified depth in _SCHED; None runs 3 passes."""
    topf = consts(x.device)["topf"]
    if site is None:
        return _norm1(_norm1(_norm1(x, topf), topf), topf)
    return _norm(x, topf, site)


def normalize(x, width: int = W):
    """Pad to `width` then carry-normalize at the `normalize` site depth."""
    return _norm(_pad_limbs(x, width), consts(x.device)["topf"], "normalize")


# ---------------------------------------------------------------- canonical


def _ripple_carry(v):
    """Exact carry ripple along the limb axis (the reference's lax.scan,
    `_ripple_carry`): the limbs masked to [0, 2^B) and the signed carry out
    of the top."""
    carry = torch.zeros_like(v[..., 0, :])
    sums = []
    for limb in v.unbind(-2):
        s = limb + carry
        carry = s >> _B_T
        sums.append(s)
    return torch.stack(sums, -2) & _MASK_T, carry


def _canonical_fn(folds, topf, x):
    """canonical() as one body, the plain version of the `canonical` kernel
    (csrc/fp_canon.cu `k_canonical`): `_canon_reduce_body`, the pad to 37
    limbs, + KP and a ripple, then the subtract ladder, p * 2^k for k = 6
    .. 0, each kept where its ripple's carry out of the top (the borrow) is
    >= 0. The reference's composition, op for op."""
    c = consts(x.device)
    x = _canon_reduce_body(x, folds, topf)
    x = _ripple_carry(_pad_limbs(x, 37) + c["kp37"])[0]
    for k in reversed(range(_LADDER_ROUNDS)):
        d, borrow = _ripple_carry(x - c["pk_ladder"][k])
        x = torch.where((borrow >= 0)[..., None, :], d, x)
    return x[..., :W, :]


# one launch per call: canon_reduce, the 8 ripples and the ladder in
# registers, one thread per lane element, the tables in the block's shared
# memory
canonical_op = KernelOp(_canonical_fn, "canonical", "lh_fp_canonical")


def canonical(x):
    """Unique representative in [0, p); canonical limbs [..., W, S]."""
    return canonical_op(x)


def eq_zero(x):
    """True where lazy x === 0 (mod p); shape [..., S]."""
    return (canonical(x) == 0).all(dim=-2)


def eq(x, y):
    return eq_zero(x - y)


# ---------------------------------------------------------------- pow / inv


def one_like(a):
    """The element 1 (fp.ONE) broadcast to the shape of `a`."""
    return torch.from_numpy(ONE).to(a.device)[:, None].expand(a.shape)


def pow_const(a, exponent: int):
    """a^e for a static int e: LSB-first square-and-multiply. The
    reference scans the bits with the multiply under lax.cond; this loop
    makes the same calls (`mul` on set bits, `sqr` on every bit, the last
    one included), so the limbs are identical."""
    acc = one_like(a).contiguous()
    base = norm3_x(a, site="fp.pow_const.entry")
    for i in range(max(exponent.bit_length(), 1)):
        if (exponent >> i) & 1:
            acc = mul(acc, base)
        base = sqr(base)
    return acc


def _inv_bin_body(folds, topf, a, one=None):
    """a^(p-2) by `pow_const`'s LSB-first binary chain, as one body: the
    plain version of the `inv_bin` kernel, whose cooperative program
    (ops/lane/coop.py) is traced from it. It calls `_mul_body` and
    `_sqr_fn` in the order `pow_const(a, P - 2)` calls the `mul` and `sqr`
    kernels (229 products on the set bits, a square on every bit), so the
    limbs are `pow_const`'s. One call is left out: the square of `base`
    after the last bit, whose result nothing reads (a program holds no
    job whose result is never read); it changes no output limb. `one`:
    the 1 the product starts from (a row of the program; the kernel
    writes it)."""
    e = P - 2
    acc = one_like(a) if one is None else one
    base = _norm(a, topf, "fp.pow_const.entry")
    n = e.bit_length()
    for i in range(n):
        if (e >> i) & 1:
            acc = _mul_body(acc, base, folds, topf)
        if i < n - 1:
            base = _sqr_fn(folds, topf, base)
    return acc


# one launch per inversion: 229 products and 380 squares on a block of
# warps per lane element (csrc/inv.cu)
inv_bin = KernelOp(_inv_bin_body, "inv_bin", "lh_inv_bin")


def inv(a):
    """a^(p-2): Fermat inversion (0 maps to 0), `pow_const`'s chain in one
    kernel (`inv_bin`)."""
    return inv_bin(a)


def batch_inv(a):
    """Elementwise inverses of a stack [K, ..., W, S], amortized over the
    STACK axis: prefix products along axis 0, one Fermat inversion, then
    back-substitution; zero slots map to zero. 3(K-1) `mul` and one `inv`
    in the reference's order, so the limbs are the reference's."""
    K = a.shape[0]
    if K == 1:
        return inv(a)
    is_z = eq_zero(a)[..., None, :]                     # [K, ..., 1, S]
    one = torch.from_numpy(ONE).to(a.device)[:, None]
    safe = torch.where(is_z, one, a)
    prefix = [safe[0]]
    for k in range(1, K):
        prefix.append(mul(prefix[-1], safe[k]))
    acc = inv(prefix[-1])
    outs = [None] * K
    for k in range(K - 1, 0, -1):
        outs[k] = mul(acc, prefix[k - 1])
        acc = mul(acc, safe[k])
    outs[0] = acc
    out = torch.stack(outs, 0)
    return torch.where(is_z, torch.zeros_like(out), out)
