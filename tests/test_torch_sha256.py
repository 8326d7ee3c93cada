"""The port's state hashing against the reference's.

lighthouse_tpu_torch/ops/lane/sha256.py keeps the reference's constants
(K, IV, the padding block's K + W) and its two-block merkle-node digest as
a plain PyTorch body, the yardstick of csrc/sha256.cu `k_sha256_pairs`;
ops/lane/merkle.py merkleizes words one launch a level. Held here on the
CPU: the constants against the reference's and against the CUDA source's
literals, the plain body against the reference's numpy body and hashlib,
the port's merkleize against ssz.merkleize, and the reference's own
batched scheduler (`merkle.prewarm`) run through the port's body, installed
at the reference's backend seam for the test only.
"""

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu.consensus import ssz
from lighthouse_tpu.ops.lane import merkle as ref_merkle, sha256 as ref
from lighthouse_tpu_torch.ops.lane import fp, merkle as M, sha256 as H

CSRC = Path(__file__).resolve().parents[1] / "lighthouse_tpu_torch" / "csrc" / "sha256.cu"


def _literal(src: str, name: str) -> list:
    body = re.search(rf"constexpr uint32_t {name}\[\d+\] = \{{(.*?)\}};", src, re.S).group(1)
    return [int(x, 16) for x in re.findall(r"0x([0-9a-f]{8})u", body)]


def test_constants_equal_reference_and_cuda_source():
    assert np.array_equal(H.K, ref.K) and np.array_equal(H.IV, ref.IV)
    assert np.array_equal(H._KW_PAD, ref._KW_PAD)
    assert H.K.dtype == H.IV.dtype == H._KW_PAD.dtype == np.uint32
    src = CSRC.read_text()
    assert _literal(src, "kK") == H.K.tolist()
    assert _literal(src, "kKWPad") == H._KW_PAD.tolist()
    assert _literal(src, "kIV") == H.IV.tolist()


@pytest.mark.parametrize("n", [1, 2, 261])
def test_plain_body_equals_reference(n):
    """Seeded words: the port's plain body (node-major (N, 8) int32) gives
    the reference's numpy body's and hashlib's digests (lane-major (8, N)
    uint32); the port's oracle is the reference's."""
    rng = np.random.default_rng(2100 + n)
    left = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint32)
    right = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint32)
    fp.reset_counts()
    got = H.digest_pairs(H.as_tensor(left), H.as_tensor(right))
    assert got.dtype == torch.int32 and got.shape == (n, 8)
    got = got.numpy().view(np.uint32)
    assert np.array_equal(got, ref._numpy_pairs(left.T, right.T).T)
    assert np.array_equal(got, ref.oracle_pairs(left.T, right.T).T)
    assert np.array_equal(H.oracle_pairs(left.T, right.T), ref.oracle_pairs(left.T, right.T))
    assert not fp.LAUNCHES and not fp.PLAIN_CUDA_CALLS


def test_compress_pairs_contract_and_layer_views():
    """compress_pairs keeps the reference's (N, 8) uint32 contract on the
    CPU, N = 0 included; a layer's rows 2j and 2j + 1 as strided views give
    the same digests as the rows copied out."""
    rng = np.random.default_rng(2110)
    left = rng.integers(0, 1 << 32, (5, 8), dtype=np.uint32)
    right = rng.integers(0, 1 << 32, (5, 8), dtype=np.uint32)
    got = H.compress_pairs(left, right, device="cpu")
    assert got.dtype == np.uint32 and got.shape == (5, 8)
    assert np.array_equal(got, ref.oracle_pairs(left.T, right.T).T)
    empty = H.compress_pairs(np.empty((0, 8), np.uint32), np.empty((0, 8), np.uint32),
                             device="cpu")
    assert empty.shape == (0, 8) and empty.dtype == np.uint32
    layer = H.as_tensor(np.concatenate([left, right], axis=1).reshape(10, 8))
    assert np.array_equal(H.digest_pairs(layer[0::2], layer[1::2]).numpy().view(np.uint32), got)
    with pytest.raises(ValueError):
        H.compress_pairs(left, right[:4], device="cpu")


def test_chunk_words_round_trip():
    data = bytes(range(256)) * 2
    words = H.words_from_chunks(data)
    assert words.shape == (16, 8) and words[0, 0] == 0x00010203
    assert H.chunks_from_words(words) == data
    assert H.chunks_from_words(H.as_tensor(words)) == data
    assert H.words_from_chunks(np.frombuffer(data[:40], np.uint8)).shape == (2, 8)


def test_zero_words_equal_reference():
    assert M.ZERO_CHUNKS == ssz._ZERO_CHUNKS
    assert np.array_equal(M.ZERO_WORDS, np.stack(ref_merkle._ZERO_WORDS))


@pytest.mark.parametrize("count", range(1, 10))
def test_merkleize_equals_ssz(count):
    """The port's merkleize (the device levels, then the host's zero
    spine) equals ssz.merkleize at the count, at limits above it and with
    the length mixed in; reduce_layers equals it on a stack of subtrees."""
    rng = np.random.default_rng(2120 + count)
    chunks = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(count)]
    words = H.as_tensor(H.words_from_chunks(b"".join(chunks)))
    for limit in (None, 16):
        assert M.merkleize(words, limit) == ssz.merkleize(chunks, limit), limit
    root = M.merkleize(words, 1 << 40)
    assert M.mix_in_length(root, count) == ssz.mix_in_length(ssz.merkleize(chunks, 1 << 40), count)
    stack = torch.stack([words, words.flip(0)])
    roots = M.reduce_layers(stack)
    assert H.chunks_from_words(roots[0]) == ssz.merkleize(chunks)
    assert H.chunks_from_words(roots[1]) == ssz.merkleize(chunks[::-1])
    assert len(M.level_pairs(count)) == max(0, (count - 1).bit_length())


def test_merkleize_empty_and_over_limit():
    none = torch.empty((0, 8), dtype=torch.int32)
    assert M.merkleize(none, 1 << 10) == ssz.merkleize([], 1 << 10) == M.ZERO_CHUNKS[10]
    with pytest.raises(ValueError):
        M.merkleize(torch.zeros((3, 8), dtype=torch.int32), 2)


_VAL = ssz.Container("TorchShaVal", [
    ("pubkey", ssz.Bytes48), ("wc", ssz.Bytes32), ("eff", ssz.uint64),
    ("slashed", ssz.boolean), ("a", ssz.uint64), ("b", ssz.uint64),
    ("c", ssz.uint64), ("d", ssz.uint64),
])
# 5 fields: a non-power-of-two element tree; Bytes96 packs to 3 chunks
_ODD = ssz.Container("TorchShaOdd", [
    ("pk", ssz.Bytes48), ("amt", ssz.uint64), ("sig", ssz.Bytes96),
    ("slot", ssz.uint64), ("flag", ssz.boolean),
])
_STATE = ssz.Container("TorchShaState", [
    ("bal", ssz.List(ssz.uint64, 1 << 24)),
    ("flags", ssz.List(ssz.uint8, 1 << 24)),
    ("roots", ssz.List(ssz.Bytes32, 1 << 16)),
    ("vals", ssz.List(_VAL, 1 << 20)),
    ("odds", ssz.List(_ODD, 1 << 20)),
    ("slot", ssz.uint64),
])


def _small_state(rng):
    """tests/test_sha256_lane.py's state shape at a few hundred elements a
    field; ChunkedSeqs made directly (below the auto-wrap threshold)."""
    def b(k):
        return bytes(rng.integers(0, 256, k, dtype=np.uint8))

    vals = [_VAL.make(pubkey=b(48), wc=b(32), eff=int(rng.integers(0, 1 << 62)),
                      slashed=bool(i % 3 == 0), a=i, b=2 * i, c=3 * i, d=5 * i)
            for i in range(301)]
    odds = [_ODD.make(pk=b(48), amt=i, sig=b(96), slot=i, flag=bool(i % 2)) for i in range(203)]
    seq = ssz.ChunkedSeq
    return _STATE.make(
        bal=seq([int(x) for x in rng.integers(0, 1 << 62, 517)], elem=ssz.uint64),
        flags=seq([int(x) for x in rng.integers(0, 256, 333)], elem=ssz.uint8),
        roots=seq([b(32) for _ in range(257)], elem=ssz.Bytes32),
        vals=seq(vals, elem=_VAL),
        odds=seq(odds, elem=_ODD),
        slot=7,
    )


def test_prewarm_through_the_reference_seam(monkeypatch):
    """The slice as a whole: the reference's batched scheduler
    (`merkle.prewarm`, threshold 0) on the port's plain body, installed as
    the reference's sha256 backend for this test only, writes chunk roots
    under which the state's root equals the scalar path's."""
    calls = []

    def port_backend(left, right):  # the reference's lane-major (8, N) seam
        calls.append(left.shape[1])
        out = H.compress_pairs(np.ascontiguousarray(left.T), np.ascontiguousarray(right.T),
                               device="cpu")
        return np.ascontiguousarray(out.T)

    monkeypatch.setattr(ref, "_BACKEND", port_backend)
    monkeypatch.setattr(ref, "_BACKEND_NAME", "torch")
    scalar = _STATE.hash_tree_root(_small_state(np.random.default_rng(2130)))
    batched = _small_state(np.random.default_rng(2130))
    info = ref_merkle.prewarm(batched, threshold=0)
    assert info is not None and info["backend"] == "torch"
    assert set(info["fields"]) == {"bal", "flags", "roots", "vals", "odds"}
    assert calls and info["compressions"] == 2 * sum(calls)
    assert _STATE.hash_tree_root(batched) == scalar
    want = hashlib.sha256(bytes(64)).digest()
    assert ref.compress_pairs(np.zeros((1, 8), np.uint32), np.zeros((1, 8), np.uint32)
                              ).astype(">u4").tobytes() == want
