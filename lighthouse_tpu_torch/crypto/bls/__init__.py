"""BLS12-381 signatures: the port's front, over host arithmetic copied from
the reference's jax-free modules (params, fields, curve, pairing,
pairing_fast, hash_to_curve, keys) and two batch backends (backends/):
`cuda`, the device path, and `cpu`, the pure-Python control.

`verify_signature_sets` is the seam every gossip, block and sync verifier
funnels into. The random batch scalars are drawn on the host with the
`secrets` CSPRNG (64 bits, nonzero), never on the device.
"""

import secrets

from . import backends as _backends
from . import params
from .keys import (
    PublicKey,
    SecretKey,
    Signature,
    SignatureSet,
    aggregate_pubkey_point,
    aggregate_signatures,
)


def gen_batch_scalars(n: int):
    """n nonzero RAND_BITS-bit CSPRNG scalars."""
    out = []
    for _ in range(n):
        r = 0
        while r == 0:
            r = secrets.randbits(params.RAND_BITS)
        out.append(r)
    return out


def _device_kw(name: str, device) -> dict:
    if device is None:
        return {}
    if name != "cuda":
        raise ValueError(f"backend {name!r} takes no device")
    return {"device": device}


def verify_signature_sets(sets, *, backend: str = "cuda", rand_scalars=None, device=None) -> bool:
    """Batch-verify independently signed SignatureSets: True only if every
    set verifies. The `cuda` backend runs on the GPU unless `device` names
    another ("cpu" runs the kernels' plain bodies)."""
    b = _backends.get(backend)
    if rand_scalars is None:
        rand_scalars = gen_batch_scalars(len(sets))
    return b.verify_signature_sets(sets, rand_scalars, **_device_kw(backend, device))


def verify(signature, pubkey, message: bytes, *, backend: str = "cuda", device=None) -> bool:
    """Single-signature verification."""
    b = _backends.get(backend)
    return b.verify_single(signature, pubkey, message, **_device_kw(backend, device))


__all__ = [
    "params",
    "SecretKey",
    "PublicKey",
    "Signature",
    "SignatureSet",
    "aggregate_signatures",
    "aggregate_pubkey_point",
    "gen_batch_scalars",
    "verify_signature_sets",
    "verify",
]
