"""The batched BLS backend on the hand-written CUDA kernels: the port of
lighthouse_tpu/crypto/bls/backends/tpu.py.

The same semantics as the CPU control (backends/cpu.py): random linear
combination batch verification,

    prod_i e([r_i] apk_i, H(m_i)) * e(-g1, sum_i [r_i] sig_i) == 1,

with every expensive step on the device over the whole batch: hash-to-G2
(ops/lane/htc.py), the signature subgroup checks psi(S) == -[|u|]S, the
64-bit windowed ladders on G1 and G2 (ops/lane/chains.py), the lane sum of
[r]S, the affine conversions, n+1 Miller loops, one final exponentiation
and the == 1 verdict (ops/lane/pairing.py).

Division of labour:
  host   - input policy checks (empty input, a set with no keys, an
           infinity signature or aggregate pubkey), per-set pubkey
           aggregation, SHA-256 message expansion, packing.
  device - all field, curve and pairing arithmetic, batched along the
           lane axis, padded to power-of-two buckets >= 128
           (params.lane_bucket); padding lanes carry the generators,
           message b"" and r = 0, and are masked out of the product.

`verify_core` is the un-jitted counterpart of the reference's
`_verify_kernel`; the reference's AOT export ladder has no counterpart
(kernels are built once per source hash by ops/lane/kernels.py).
Entry points run on CUDA unless the caller passes device="cpu", which runs
the kernels' plain PyTorch bodies.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque

import numpy as np
import torch

from ....ops.lane import chains, fastpack, fp, htc, jacobian as J, pairing as OP, tower
from .. import curve as C
from .. import params
from ..keys import SignatureSet

W = fp.W

_G1_GEN_NEG_X = fp.to_limbs(params.G1X)
_G1_GEN_NEG_Y = fp.to_limbs((-params.G1Y) % params.P)
_M_ABS = -params.X

# seconds per verify, by padded bucket: {"host_pack": ..., "device": ...},
# each the last TIMES_WINDOW verifies' (host_pack: policy checks,
# aggregation, hashing, packing and the copy to the device; device:
# verify_core up to the verdict on the host). A fixed window, so a node's
# process holds a bounded record however many verifies it makes.
TIMES_WINDOW = 256
TIMES: dict = defaultdict(
    lambda: {"host_pack": deque(maxlen=TIMES_WINDOW), "device": deque(maxlen=TIMES_WINDOW)}
)


def _to_affine_g1(p):
    X, Y, Z = p
    zi = chains.inv(Z)
    zi2 = fp.sqr(zi)
    return fp.mul(X, zi2), fp.mul(fp.mul(Y, zi2), zi)


def _to_affine_g2(p):
    X, Y, Z = p
    zi = chains.f2inv(Z)
    zi2 = tower.f2sqr(zi)
    return tower.f2mul(X, zi2), tower.f2mul(tower.f2mul(Y, zi2), zi)


def local_phase(apk_x, apk_y, sig_x, sig_y, t0, t1, rbits, pad):
    """Everything but the global signature aggregate's pair. Lane-major
    tensors on one device: apk_* [W, S]; sig_*, t0, t1 [2, W, S]; rbits
    [64, S] int32; pad [S] bool. Returns
      f_local [2, 3, 2, W, 1] - the product of the lanes' Miller values,
      s_local              - the SUM of [r_i] sig_i (Jacobian G2, 1 lane),
      sub_ok_all []        - the AND of the lanes' subgroup checks."""
    S = apk_x.shape[-1]
    dev = apk_x.device
    one1 = torch.from_numpy(fp.ONE).to(dev)[:, None].expand(W, S)
    one2 = tower.bcast(tower.consts(dev)["f2_one"], S)

    # hash-to-curve for all messages
    hm = htc.hash_draws_to_g2(t0, t1)                    # [2, W, S] Jacobian

    # [r]S through the windowed ladder; the subgroup check's [|u|]S on its
    # own static chain
    sig_jac = (sig_x, sig_y, one2)
    r_sig = chains.scalar_mul_w2(J.FP2, sig_jac, rbits)
    m_sig = J.scalar_mul_static(J.FP2, sig_jac, _M_ABS)

    # signature subgroup checks: psi(S) == [u]S = -[|u|]S
    sub_ok = J.jac_eq(J.FP2, J.psi(sig_jac), J.neg(J.FP2, m_sig)) | pad

    s_local = J.lane_sum(J.FP2, r_sig, S)
    r_apk = chains.scalar_mul_w2(J.FP1, (apk_x, apk_y, one1), rbits)

    # to affine for the Miller loop
    px, py = _to_affine_g1(r_apk)
    qx, qy = _to_affine_g2(hm)
    q_inf = J.FP2.is_zero_struct(hm[2]) | pad

    fs = OP.miller_loop(px, py, qx, qy, p_inf=pad, q_inf=q_inf)
    f_local = OP.lane_product(fs, S)
    return f_local, s_local, sub_ok.all()


def finish_phase(f_prod, s_agg, sub_ok_all):
    """The (-g1, S) pair, the final exponentiation and the verdict (a
    0-dim bool tensor)."""
    dev = f_prod.device
    sx, sy = _to_affine_g2(s_agg)
    s_inf = J.FP2.is_zero_struct(s_agg[2])
    xP = torch.from_numpy(_G1_GEN_NEG_X).to(dev)[:, None]
    yP = torch.from_numpy(_G1_GEN_NEG_Y).to(dev)[:, None]
    f_last = OP.miller_loop(xP, yP, sx, sy, q_inf=s_inf)
    prod = tower.f12mul(f_prod, f_last)
    ok = tower.f12_eq_one(OP.final_exp(prod))
    return ok.all() & sub_ok_all


def verify_core(apk_x, apk_y, sig_x, sig_y, t0, t1, rbits, pad):
    """One single-device batch verification (a 0-dim bool tensor)."""
    return finish_phase(*local_phase(apk_x, apk_y, sig_x, sig_y, t0, t1, rbits, pad))


# ------------------------------------------------------------ host packing


def prepare_batch(sets, rand_scalars):
    """Host packing: sets -> the 8 numpy arrays of `local_phase`, or None
    when policy rejects the batch (empty input, a set with no keys, an
    infinity signature or aggregate pubkey). Raises ValueError for a
    scalar outside (0, 2^64)."""
    n = len(sets)
    if n == 0:
        return None
    apk_pts, sig_pts, msgs = [], [], []
    for s, r in zip(sets, rand_scalars):
        if not s.signing_keys:
            return None
        if not (0 < r < 2**params.RAND_BITS):
            raise ValueError("batch scalar out of range")
        if s.signature.point is None:
            return None
        apk = None
        for k in s.signing_keys:
            apk = C.g1_add(apk, k.point)
        if apk is None:
            return None
        apk_pts.append(apk)
        sig_pts.append(s.signature.point)
        msgs.append(s.message)

    npad = params.lane_bucket(n)
    extra = npad - n
    apk_x = fastpack.pack_ints([p[0] for p in apk_pts] + [params.G1X] * extra)
    apk_y = fastpack.pack_ints([p[1] for p in apk_pts] + [params.G1Y] * extra)
    sig_x = fastpack.f2_pack_many([p[0] for p in sig_pts] + [params.G2X] * extra)
    sig_y = fastpack.f2_pack_many([p[1] for p in sig_pts] + [params.G2Y] * extra)
    t0, t1 = htc.pack_draws(msgs + [b""] * extra)
    rbits = np.zeros((64, npad), dtype=np.int32)
    rbits[:, :n] = J.scalars_to_bits(rand_scalars, 64)
    pad = np.zeros(npad, dtype=bool)
    pad[n:] = True
    return apk_x, apk_y, sig_x, sig_y, t0, t1, rbits, pad


def to_device(args, device) -> tuple:
    """prepare_batch's numpy arrays -> tensors on `device` (int32, pad bool)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args)


def verify_signature_sets(sets, rand_scalars, device=None) -> bool:
    dev = fp.resolve_device(device)
    t0 = time.perf_counter()
    args = prepare_batch(sets, rand_scalars)
    if args is None:
        return False
    targs = to_device(args, dev)
    t1 = time.perf_counter()
    # bool() waits for the verdict: this covers launch, compute and copy back
    ok = bool(verify_core(*targs))
    t2 = time.perf_counter()
    rec = TIMES[int(args[0].shape[-1])]
    rec["host_pack"].append(t1 - t0)
    rec["device"].append(t2 - t1)
    return ok


def verify_single(signature, pubkey, message: bytes, device=None) -> bool:
    if signature.point is None:
        return False
    s = SignatureSet.single_pubkey(signature, pubkey, message)
    return verify_signature_sets([s], [1], device=device)
