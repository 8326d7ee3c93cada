"""Batched SHA-256 merkle-node compression in PyTorch, with a hand-written
CUDA kernel.

Port of lighthouse_tpu/ops/lane/sha256.py: the digest of N independent
merkle nodes, each SHA-256 over the 64-byte concatenation of two 32-byte
children. That is two compressions a node: the data block (the sixteen
child words, with the 48 steps of its message schedule), then SHA-256's
constant padding block, whose schedule is input-independent and folds into
the per-round constants `_KW_PAD`.

Words are the big-endian values of the children (numpy `>u4`), as the
reference's. On the card they are int32 tensors holding the same 32 bits;
the kernel (csrc/sha256.cu `k_sha256_pairs`, one thread a node) swaps no
bytes. `_digest_pairs` is its plain PyTorch version, the reference's two
blocks operation for operation on int64 values kept in [0, 2^32), which the
CPU tests hold against the reference's numpy body and hashlib.

The reference pads each dispatch to a lane bucket (`_BUCKETS`) and loops
over 32,768-lane slices, for its jit cache; the kernel takes any N in one
launch, so neither is ported.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np
import torch

from . import fp, kernels

# SHA-256 round constants / initial state (FIPS 180-4)
K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
    0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
    0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
    0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
    0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
    0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
    0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
    0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
    0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

IV = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)

_M32 = 0xFFFFFFFF


def _pad_schedule() -> np.ndarray:
    """K[t] + W[t] for the constant second block of a 64-byte message
    (the 0x80 delimiter, zeros, the bit length 512), in Python ints."""
    w = [0x80000000] + [0] * 14 + [512]
    for t in range(16, 64):
        x15, x2 = w[t - 15], w[t - 2]
        s0 = (((x15 >> 7) | (x15 << 25)) ^ ((x15 >> 18) | (x15 << 14))
              ^ (x15 >> 3)) & _M32
        s1 = (((x2 >> 17) | (x2 << 15)) ^ ((x2 >> 19) | (x2 << 13))
              ^ (x2 >> 10)) & _M32
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    return np.array([(int(K[t]) + w[t]) & _M32 for t in range(64)], dtype=np.uint32)


_KW_PAD = _pad_schedule()


# ---------------------------------------------------------------- host codecs


def words_from_chunks(data) -> np.ndarray:
    """Bytes, or a uint8 array [..., n], zero-padded to whole 32-byte
    chunks -> the chunks' big-endian uint32 words [..., ceil(n / 32), 8]."""
    raw = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else data
    pad = -raw.shape[-1] % 32
    if pad:
        raw = np.concatenate([raw, np.zeros((*raw.shape[:-1], pad), np.uint8)], axis=-1)
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    return raw.view(">u4").astype(np.uint32).reshape(*raw.shape[:-1], -1, 8)


def chunks_from_words(words) -> bytes:
    """[..., 8] words (uint32 numpy, or an int32 tensor of their bits) ->
    the chunks' bytes, in order."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy().view(np.uint32)
    return np.ascontiguousarray(words, dtype=np.uint32).astype(">u4").tobytes()


def as_tensor(words: np.ndarray, device=None) -> torch.Tensor:
    """uint32 words -> an int32 tensor of the same bits on `device`."""
    a = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device if device is not None else "cpu")


def oracle_pairs(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """The hashlib reference, in the reference's lane-major layout:
    left/right (8, N) uint32 words; returns (8, N)."""
    lb = np.ascontiguousarray(left.T).astype(">u4").tobytes()
    rb = np.ascontiguousarray(right.T).astype(">u4").tobytes()
    out = b"".join(
        hashlib.sha256(lb[32 * i: 32 * i + 32] + rb[32 * i: 32 * i + 32]).digest()
        for i in range(left.shape[1])
    )
    return np.frombuffer(out, dtype=">u4").reshape(-1, 8).T.astype(np.uint32)


# ---------------------------------------------------------------- plain body


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M32


def _rounds(h, w, kw=None):
    """The 64 compression rounds on int64 values in [0, 2^32): `h` the
    running state (8 tensors), `w` the 16 message words (schedule computed
    here) or None for the constant padding block (`kw` = `_KW_PAD`)."""
    if w is not None:
        w = list(w)
        for t in range(16, 64):
            x15, x2 = w[t - 15], w[t - 2]
            s0 = _rotr(x15, 7) ^ _rotr(x15, 18) ^ (x15 >> 3)
            s1 = _rotr(x2, 17) ^ _rotr(x2, 19) ^ (x2 >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, hh = h
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        if w is not None:
            t1 = hh + s1 + ch + int(K[t]) + w[t]
        else:
            t1 = hh + s1 + ch + int(kw[t])
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        hh, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    return [(x + y) & _M32 for x, y in zip(h, (a, b, c, d, e, f, g, hh))]


def _digest_pairs(left, right):
    """Merkle-node digests, the plain version of `k_sha256_pairs`:
    left/right (N, 8) int32 tensors of big-endian words; returns (N, 8)
    int32 on their device."""
    u = [(x.to(torch.int64) & _M32) for x in (left, right)]
    w16 = [u[0][:, i] for i in range(8)] + [u[1][:, i] for i in range(8)]
    h = [torch.full_like(w16[0], int(v)) for v in IV]
    h = _rounds(h, w16)             # block 1: the two child roots
    h = _rounds(h, None, _KW_PAD)   # block 2: the constant SHA padding
    out = torch.stack(h, dim=1)
    return (out - ((out >> 31) << 32)).to(torch.int32)


# ---------------------------------------------------------------- kernel

_ARGTYPES = {"lh_sha256_pairs": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]}


def _rows(x) -> bool:
    """Whether x is (N, 8) int32 rows the kernel reads in place: unit word
    stride, a row stride and a start on 16 bytes (its int4 loads)."""
    return (x.dim() == 2 and x.shape[1] == 8 and x.dtype == torch.int32
            and x.stride(1) == 1 and x.stride(0) % 4 == 0 and x.data_ptr() % 16 == 0)


class PairsKernel:
    """`k_sha256_pairs` and its plain version. Called on two (N, 8) int32
    tensors of one device: on the CPU the plain body runs; on CUDA the
    kernel launches (counted in fp.LAUNCHES as `sha256_pairs`) or raises.
    The operands may be strided views, such as a tree layer's rows 2j and
    2j + 1 (`layer[0::2]`, `layer[1::2]`, one row stride): the kernel reads
    them in place."""

    name = "sha256_pairs"

    def plain(self, left, right):
        if left.device.type == "cuda":
            fp.PLAIN_CUDA_CALLS[self.name] += 1
        return _digest_pairs(left, right)

    def __call__(self, left, right):
        if left.device != right.device:
            raise ValueError(f"{self.name}: operands on {left.device} and {right.device}")
        if left.shape != right.shape or left.dim() != 2 or left.shape[1] != 8:
            raise ValueError(f"{self.name}: operands {tuple(left.shape)}, "
                             f"{tuple(right.shape)} are not one (N, 8) shape")
        if left.dtype != torch.int32 or right.dtype != torch.int32:
            raise TypeError(f"{self.name}: operands must be int32 words")
        dev = left.device
        if dev.type == "cpu":
            return self.plain(left, right)
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for device {dev}")
        n = left.shape[0]
        out = torch.empty((n, 8), dtype=torch.int32, device=dev)
        if n == 0:
            return out
        if not (_rows(left) and _rows(right) and left.stride(0) == right.stride(0)):
            left, right = left.contiguous(), right.contiguous()
        lib = kernels.library("sha256", _ARGTYPES)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.lh_sha256_pairs(left.data_ptr(), right.data_ptr(), out.data_ptr(),
                                     left.stride(0), n, stream)
        if rc:
            msg = lib.lh_sha256_error_string(rc).decode()
            raise RuntimeError(f"lh_sha256_pairs: CUDA error {rc}: {msg}")
        fp.LAUNCHES[self.name] += 1
        return out


digest_pairs = PairsKernel()


def compress_pairs(left: np.ndarray, right: np.ndarray, device=None) -> np.ndarray:
    """Hash N merkle nodes in one batch: left/right are (N, 8) uint32
    big-endian child-root words; returns (N, 8) parent words, bit-identical
    to sha256(left || right) per row. Runs on CUDA (one launch) unless the
    caller names the CPU; raises where there is no GPU."""
    dev = fp.resolve_device(device)
    if left.shape != right.shape or left.ndim != 2 or left.shape[1] != 8:
        raise ValueError(f"compress_pairs: operands {left.shape}, {right.shape} are not (N, 8)")
    out = digest_pairs(as_tensor(left, dev), as_tensor(right, dev))
    return out.cpu().numpy().view(np.uint32)
