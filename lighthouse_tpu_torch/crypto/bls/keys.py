"""BLS key and signature types: the port's copy of
lighthouse_tpu/crypto/bls/keys.py over its own `curve`/`hash_to_curve`.

Plain classes holding affine points and their compressed wire encodings.
The batch backends read only `SignatureSet.signing_keys[i].point`,
`.signature.point` and `.message`, so they take the reference's objects
as well.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Sequence

from . import curve as C
from . import hash_to_curve as H2C
from . import params

# pubkey memoization keyed on a DIGEST of the secret, never the raw
# scalar: the cache keeps no secret key material. Values are immutable
# affine points.
_PUBKEY_CACHE: dict = {}
_PUBKEY_CACHE_MAX = 4096


def _pubkey_point(scalar: int):
    h = hashlib.sha256(b"lh-pk-cache" + scalar.to_bytes(32, "big")).digest()
    pt = _PUBKEY_CACHE.get(h)
    if pt is None:
        pt = C.g1_mul(C.G1_GEN, scalar)
        if len(_PUBKEY_CACHE) < _PUBKEY_CACHE_MAX:
            _PUBKEY_CACHE[h] = pt
    return pt


class SecretKey:
    __slots__ = ("scalar",)

    def __init__(self, scalar: int):
        if not 0 < scalar < params.R:
            raise ValueError("secret key scalar out of range")
        self.scalar = scalar

    @classmethod
    def from_seed(cls, seed: bytes) -> "SecretKey":
        """Deterministic dev keygen (not EIP-2333 derivation)."""
        h = hashlib.sha256(b"lighthouse-tpu-keygen" + seed).digest()
        return cls(int.from_bytes(h + hashlib.sha256(h).digest(), "big") % (params.R - 1) + 1)

    def public_key(self) -> "PublicKey":
        return PublicKey(point=_pubkey_point(self.scalar))

    def sign(self, message: bytes) -> "Signature":
        return Signature(point=C.g2_mul(H2C.hash_to_g2(message), self.scalar))


class PublicKey:
    """A G1 public key: the decompressed, subgroup-checked affine point."""

    __slots__ = ("point", "_compressed")

    def __init__(self, point=None, compressed: Optional[bytes] = None):
        if point is None and compressed is None:
            raise ValueError("need point or compressed bytes")
        self.point = point
        self._compressed = compressed
        if self.point is None:
            self.point = C.g1_decompress(compressed)
        if self.point is None:
            raise ValueError("infinity public key rejected")

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        return cls(compressed=data)

    def to_bytes(self) -> bytes:
        if self._compressed is None:
            self._compressed = C.g1_compress(self.point)
        return self._compressed

    def __eq__(self, other):
        return isinstance(other, PublicKey) and self.point == other.point

    def __hash__(self):
        return hash(self.to_bytes())


class Signature:
    """A G2 signature (possibly an aggregate). Decompression performs the
    subgroup check."""

    __slots__ = ("point", "_compressed")

    def __init__(self, point=None, compressed: Optional[bytes] = None):
        self.point = point
        self._compressed = compressed
        if self.point is None and compressed is not None:
            self.point = C.g2_decompress(compressed)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        return cls(compressed=data)

    def to_bytes(self) -> bytes:
        if self._compressed is None:
            self._compressed = C.g2_compress(self.point)
        return self._compressed

    def is_infinity(self) -> bool:
        return self.point is None

    def __eq__(self, other):
        return isinstance(other, Signature) and self.point == other.point


def aggregate_signatures(sigs: Sequence[Signature]) -> Signature:
    acc = None
    for s in sigs:
        acc = C.g2_add(acc, s.point)
    return Signature(point=acc)


def aggregate_pubkey_point(keys: Sequence[PublicKey]):
    acc = None
    for k in keys:
        acc = C.g1_add(acc, k.point)
    return acc


@dataclass
class SignatureSet:
    """One independently verifiable (signature, pubkeys, message) triple."""

    signature: Signature
    signing_keys: Sequence[PublicKey]
    message: bytes

    @classmethod
    def single_pubkey(cls, signature: Signature, key: PublicKey, message: bytes):
        return cls(signature=signature, signing_keys=[key], message=message)

    @classmethod
    def multiple_pubkeys(cls, signature: Signature, keys: Sequence[PublicKey], message: bytes):
        return cls(signature=signature, signing_keys=list(keys), message=message)
