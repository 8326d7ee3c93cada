"""Vectorized host packing for the lane layout: the port's copy of
lighthouse_tpu/ops/lane/fastpack.py.

`fp.pack` goes through one bit-unpack per call; this reads each limb as a
32-bit little-endian window of the element's 48 bytes, shifted and masked,
for the whole batch at once. Bit-identical to `fp.pack` on canonical ints
(tests/test_torch_htc.py pins it). `prepare_batch` (crypto/bls/backends/
cuda.py) packs every batch through it.
"""

from __future__ import annotations

import numpy as np

from . import fp

_B = fp.B
_W = fp.W
_BYTES = 48                           # 384 bits hold any canonical Fp
_MASK = (1 << _B) - 1

# limb i occupies bits [11i, 11i+11): read a 32-bit little-endian window
# at byte offset (11i)//8 and shift by (11i)%8
_BYTE_OFF = (np.arange(_W) * _B) // 8                     # [W]
_BIT_SHIFT = ((np.arange(_W) * _B) % 8).astype(np.int64)  # [W]
_GATHER = _BYTE_OFF[:, None] + np.arange(4)[None, :]      # [W, 4]
_BYTE_W = 1 << (8 * np.arange(4, dtype=np.int64))         # LE weights


def pack_ints(ints) -> np.ndarray:
    """Iterable of canonical python ints -> [W, n] int32 limbs
    (lane-major), bit-identical to fp.pack."""
    vals = list(ints)
    n = len(vals)
    if n == 0:
        return np.zeros((_W, 0), dtype=np.int32)
    buf = b"".join(v.to_bytes(_BYTES, "little") for v in vals)
    a = np.frombuffer(buf, dtype=np.uint8).reshape(n, _BYTES)
    a = np.pad(a, ((0, 0), (0, 4)))                      # window overrun pad
    windows = a[:, _GATHER].astype(np.int64) @ _BYTE_W   # [n, W] u32 reads
    limbs = (windows >> _BIT_SHIFT) & _MASK
    return np.ascontiguousarray(limbs.T).astype(np.int32)


def f2_pack_many(pairs) -> np.ndarray:
    """[(a0, a1)] -> [2, W, n] limbs (tower.f2_pack_many's layout)."""
    return np.stack(
        [pack_ints([p[0] for p in pairs]), pack_ints([p[1] for p in pairs])]
    )
