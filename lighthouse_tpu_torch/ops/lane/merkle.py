"""Merkle trees over 32-byte chunks on the card, one launch a tree level.

Port of the part of lighthouse_tpu/ops/lane/merkle.py that needs no SSZ
types: the zero-subtree words, the odd-layer padding of `_Level.add`, the
level reduction `_reduce_layers`, and counterparts of `ssz.merkleize` and
`ssz.mix_in_length` (lighthouse_tpu/consensus/ssz.py:72, :90) on words.

A layer is an int32 tensor [..., 8] of big-endian chunk words
(ops/lane/sha256.py). Each level is one launch of `k_sha256_pairs`, which
reads rows 2j and 2j + 1 of the flat layer in place; a layer of odd width
takes the level's zero subtree as its last node first, as ssz.merkleize
does. Every level with more than one node stays on the card. What is left
above a field's data, the zero-padding spine up to the type's limit and
the length mix-in, is a few single hashes on the host, as in the
reference.

The scheduler that walks a state's SSZ values (`scan`, `_FlatPlan`,
`prewarm`) is not ported yet.
"""

from __future__ import annotations

import hashlib

import torch

from . import sha256

# the root of an all-zero subtree of 2^d chunks, d = 0 .. 64 (ssz._ZERO_CHUNKS)
ZERO_CHUNKS = [b"\x00" * 32]
for _ in range(64):
    ZERO_CHUNKS.append(hashlib.sha256(ZERO_CHUNKS[-1] + ZERO_CHUNKS[-1]).digest())
# and as words, [65, 8] uint32 (the reference's _ZERO_WORDS)
ZERO_WORDS = sha256.words_from_chunks(b"".join(ZERO_CHUNKS))

_DEVICE_ZEROS: dict = {}


def _zero_words(device) -> torch.Tensor:
    device = torch.device(device)
    z = _DEVICE_ZEROS.get(device)
    if z is None:
        z = _DEVICE_ZEROS[device] = sha256.as_tensor(ZERO_WORDS, device)
    return z


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def level(layer: torch.Tensor, d: int) -> torch.Tensor:
    """One tree level of M subtrees: layer [M, n, 8] at depth d (its nodes
    roots of 2^d chunks) -> [M, ceil(n / 2), 8], one launch. An odd n
    takes the depth-d zero subtree as its last node first."""
    m, n = layer.shape[:2]
    if n % 2:
        z = _zero_words(layer.device)[d].expand(m, 1, 8)
        layer = torch.cat([layer, z], dim=1)
    flat = layer.reshape(-1, 8)
    return sha256.digest_pairs(flat[0::2], flat[1::2]).reshape(m, -1, 8)


def reduce_layers(layer: torch.Tensor) -> torch.Tensor:
    """Merkleize M subtrees [M, width, 8] level by level, with ssz's
    odd-layer zero padding, to their roots [M, 8]: value- and
    count-identical to ssz.merkleize of each subtree's chunks (with no
    limit). One launch a level, every level on the layer's device."""
    d = 0
    while layer.shape[1] > 1:
        layer = level(layer, d)
        d += 1
    return layer[:, 0]


def merkleize(words: torch.Tensor, limit: int | None = None) -> bytes:
    """ssz.merkleize on chunk words [count, 8]: the root of the binary tree
    over them, padded with zero subtrees to `limit` (or to the count)
    leaves. The levels with more than one node run on the words' device;
    the spine above them, a hash with a zero subtree a level, on the host."""
    count = words.shape[0]
    if limit is not None and count > limit:
        raise ValueError("chunk count exceeds limit")
    depth = next_pow2(limit if limit is not None else count).bit_length() - 1
    if count == 0:
        return ZERO_CHUNKS[depth]
    root = sha256.chunks_from_words(reduce_layers(words.reshape(1, count, 8))[0])
    for k in range(len(level_pairs(count)), depth):
        root = hashlib.sha256(root + ZERO_CHUNKS[k]).digest()
    return root


def mix_in_length(root: bytes, length: int) -> bytes:
    return hashlib.sha256(root + length.to_bytes(32, "little")).digest()


def level_pairs(count: int) -> list:
    """The pairs of each level `merkleize` runs on the card over `count`
    chunks (each level's node count halved, rounded up), bottom first."""
    out = []
    while count > 1:
        count = (count + 1) // 2
        out.append(count)
    return out

