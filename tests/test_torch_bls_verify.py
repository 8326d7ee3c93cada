"""The port's BLS batch verification (crypto/bls/backends/cuda.py) on the CPU.

Fast tier: host packing limb-equal to the reference's `prepare_batch`, the
policy rejections, one valid 2-set verdict through `local_phase` +
`finish_phase` on the packed batch cut to its 2 real lanes (against the
`cpu` backend), the bounded record of verify times, the launches per
verify at buckets 128 and 1024 equal to the reference's dispatch census op
by op, each Fermat inversion's chain, hash-to-G2's ratio chain, the G1
exact add and each canonical() in one launch (with shape-only stand-ins for the kernels, as
the reference's census runs; tools/verify_census.py).
`crypto_heavy`: `local_phase` limb-equal to the reference's at 4 lanes, the
verdict matrix of tests/test_tpu_backend.py on cut lanes, and one batch
through the reference's own seam with the port registered as its "cuda"
backend and the reference's dispatch hook set to raise. Tolerance: exact
limbs, or the same verdict.
"""

import json
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import curve as C
from lighthouse_tpu_torch.crypto.bls import params
from lighthouse_tpu_torch.crypto.bls.backends import cpu as CPU
from lighthouse_tpu_torch.crypto.bls.backends import cuda as CB
from lighthouse_tpu_torch.crypto.bls.keys import SecretKey, Signature, SignatureSet
from lighthouse_tpu_torch.ops.lane import chains, fp, htc
from lighthouse_tpu_torch.tools import verify_census

REPO = Path(__file__).resolve().parents[1]

# launches per verify in the reference: its dispatch census
# (lighthouse_tpu.ops.costs.verify_kernel_costs), op by op
_COMMON = {
    "sqr": 1539, "mul": 543, "cyc_sqr": 315, "miller_dbl_iter": 126,
    "g1_win_step": 32, "g2_win_step": 32, "reduce_light": 17, "miller_add_iter": 10,
    "f6mul": 4, "jac_dbl_f1": 2, "jac_add_f1": 1,
}
REFERENCE = {
    128: {**_COMMON, "f2sqr": 428, "f2mul": 358, "jac_dbl_f2": 208, "f12mul": 43,
          "canon_reduce": 38, "jac_add_f2": 32},
    1024: {**_COMMON, "f2sqr": 434, "f2mul": 376, "jac_dbl_f2": 211, "f12mul": 46,
           "canon_reduce": 44, "jac_add_f2": 35},
}
# The port runs each Fermat inversion as one kernel where the reference
# launches its chain op by op: `chains.inv` (pow_const_w4 of p - 2: the
# table's sqr and its 3 stacked mul calls, then 4 sqr and 1 mul a window)
# as `inv_w4`, `fp.inv` (pow_const: a sqr on every bit, a mul on each set
# bit) as `inv_bin`. A verify makes 3 `chains.inv` (_to_affine_g1 and
# _to_affine_g2 at the bucket's width, finish_phase's _to_affine_g2 at 1
# lane) and 1 `fp.inv` (final_exp's f12inv). Hash-to-G2's ratio chain
# (the table's f2sqr, its f2mul and its stacked f2mul, then 2 f2sqr and 1
# f2mul a window) is one launch too, `ratio_chain`, once a verify.
_E = params.P - 2
CHAIN_LAUNCHES = {
    "inv_w4": {"sqr": 1 + 4 * len(chains.window_digits(_E)),
               "mul": 3 + len(chains.window_digits(_E))},
    "inv_bin": {"sqr": _E.bit_length(), "mul": bin(_E).count("1")},
    "ratio_chain": {"f2sqr": 1 + 2 * htc._NW, "f2mul": 2 + htc._NW},
}
CHAINS_PER_VERIFY = {"inv_w4": 3, "inv_bin": 1, "ratio_chain": 1}
# canonical() is one kernel in the port, `canonical`, where the reference
# launches `canon_reduce` and runs the ripples and the ladder around it as
# XLA glue: each canon_reduce launch of the census is one canonical launch
FUSED = {"canon_reduce": "canonical"}
# The G1 exact add is one kernel in the port, `add_exact_f1`, where the
# reference launches jac_add_f1, the collision check's 2 sqr and 6 mul, its
# 2 canonical() (canon_reduce) and a jac_dbl_f1. A verify makes one:
# scalar_mul_w2's table entry 3P for [r]apk (chains.py), at the bucket's
# width.
EXACT_ADD = {"jac_add_f1": 1, "sqr": 2, "mul": 6, "canon_reduce": 2, "jac_dbl_f1": 1}
EXACT_ADDS_PER_VERIFY = 1


def _with_chains(reference: dict) -> dict:
    """The reference's census with each inversion's chain in one launch,
    the G1 exact add in one and each canonical() in one."""
    out = Counter(reference)
    for chain, n in CHAINS_PER_VERIFY.items():
        for op, per in CHAIN_LAUNCHES[chain].items():
            out[op] -= n * per
        out[chain] += n
    for op, per in EXACT_ADD.items():
        out[op] -= EXACT_ADDS_PER_VERIFY * per
    out["add_exact_f1"] += EXACT_ADDS_PER_VERIFY
    for op, fused in FUSED.items():
        out[fused] += out.pop(op)
    return {k: v for k, v in out.items() if v}


CENSUS = {bucket: _with_chains(ref) for bucket, ref in REFERENCE.items()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_sets(n, same_msg=False):
    """tests/test_tpu_backend.py's sets, from the port's keys."""
    sets = []
    for i in range(n):
        sk = SecretKey.from_seed(bytes([i + 1, 7]) * 2)
        msg = b"fixed" if same_msg else b"msg-%d" % i
        sets.append(SignatureSet.single_pubkey(sk.sign(msg), sk.public_key(), msg))
    return sets


SCALARS = [0x1234_5678_9ABC_DEF1, 0xFFFF_FFFF_FFFF_FFFF, 3, 0x8000_0000_0000_0000]


def packed(sets, scalars, lanes=None):
    """prepare_batch's arrays as CPU tensors, cut to `lanes` real lanes."""
    args = CB.to_device(CB.prepare_batch(sets, scalars), "cpu")
    return args if lanes is None else tuple(a[..., :lanes] for a in args)


def verify_cut(sets, scalars):
    """The device verdict on the batch cut to its real lanes (False when
    policy rejects it), as verify_signature_sets computes it."""
    args = CB.prepare_batch(sets, scalars)
    if args is None:
        return False
    return bool(CB.verify_core(*(a[..., : len(sets)] for a in CB.to_device(args, "cpu"))))


# ------------------------------------------------ host packing and policy


def test_prepare_batch_equals_reference():
    from lighthouse_tpu.crypto.bls.backends import tpu as ref_tpu

    sets = make_sets(3)
    sets.append(SignatureSet.multiple_pubkeys(sets[0].signature,
                                              sets[0].signing_keys + sets[1].signing_keys,
                                              b"m"))
    ref = convert.batch_from_reference(ref_tpu.prepare_batch(sets, SCALARS))
    got = packed(sets, SCALARS)
    assert len(got) == len(ref) == 8
    for g, w in zip(got, ref):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[0].shape == (fp.W, 128) and got[7].tolist() == [False] * 4 + [True] * 124


def test_policy_rejections():
    one = make_sets(1)[0]
    pk = one.signing_keys[0]
    neg_pk = type(pk)(point=C.g1_neg(pk.point))
    assert CB.prepare_batch([], []) is None
    assert CB.prepare_batch([SignatureSet(one.signature, [], b"x")], [1]) is None
    assert CB.prepare_batch(
        [SignatureSet.single_pubkey(Signature(point=None), pk, one.message)], [1]) is None
    assert CB.prepare_batch(
        [SignatureSet.multiple_pubkeys(one.signature, [pk, neg_pk], one.message)], [1]) is None
    for r in (0, 2**64):
        with pytest.raises(ValueError, match="out of range"):
            CB.prepare_batch([one], [r])
    # rejected before any device work, also through the front
    assert bls.verify_signature_sets([], backend="cuda", device="cpu") is False
    assert bls.verify_signature_sets(
        [SignatureSet(one.signature, [], b"x")], backend="cuda", device="cpu") is False


def test_cuda_requested_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bls.verify_signature_sets(make_sets(1), rand_scalars=[5])
    with pytest.raises(ValueError, match="no device"):
        bls.verify_signature_sets(make_sets(1), backend="cpu", device="cpu")


# ------------------------------------------------ the verdict


def test_two_sets_verdict_equals_cpu():
    sets, rs = make_sets(2), SCALARS[:2]
    f_local, s_local, sub_ok = CB.local_phase(*packed(sets, rs, lanes=2))
    assert f_local.shape == (2, 3, 2, fp.W, 1) and bool(sub_ok)
    assert all(c.shape == (2, fp.W, 1) for c in s_local)
    assert bool(CB.finish_phase(f_local, s_local, sub_ok)) is True
    assert CPU.verify_signature_sets(sets, rs) is True


def test_times_keep_a_fixed_window(monkeypatch):
    """The per-bucket record of host-pack and device seconds holds the
    last TIMES_WINDOW verifies however many a process makes: two verifies
    through the plain bodies at a 1-lane bucket, the window cut to one."""
    monkeypatch.setattr(CB, "TIMES_WINDOW", 1)
    monkeypatch.setattr(CB, "TIMES", type(CB.TIMES)(CB.TIMES.default_factory))
    monkeypatch.setattr(params, "lane_bucket", lambda n: 1)
    sets = make_sets(1)
    seen = []
    for r in SCALARS[:2]:
        assert CB.verify_signature_sets(sets, [r], device="cpu") is True
        seen.append(CB.TIMES[1]["device"][-1])
    assert list(CB.TIMES) == [1]
    for series in CB.TIMES[1].values():
        assert series.maxlen == 1 and len(series) == 1
    assert list(CB.TIMES[1]["device"]) == seen[1:]


# ------------------------------------------------ launches per verify


def _census(S: int) -> Counter:
    """Launches of one verify_core over S lanes, each kernel replaced by a
    stand-in that returns zeros of the kernel's output shapes (the
    path's control flow does not depend on the values)."""
    return verify_census.census(S)["launches"]


@pytest.mark.parametrize("bucket", [128, 1024])
def test_launches_per_verify_equal_reference_census(bucket):
    """The reference's census op by op, each inversion's chain, the ratio
    chain and the G1 exact add in one launch: of its 1,539 sqr and 543 mul,
    1 sqr and 11 mul are left (3 and 17 before the exact add's 2 and 6); of
    its f2sqr and f2mul, 45 and 165 (bucket 128), 51 and 183 (bucket 1024);
    of its 38 / 44 canon_reduce, 36 / 42 are as many canonical launches
    and the exact add's 2 run inside it, and canon_reduce launches no
    more; its jac_add_f1 runs inside add_exact_f1, one of its 2 jac_dbl_f1
    too; 1,084 and 1,123 launches in all (1,095 and 1,134 with the exact
    add's 12 launches)."""
    counts = _census(bucket)
    assert dict(counts) == CENSUS[bucket]
    assert (counts["sqr"], counts["mul"]) == (1, 11)
    assert (counts["add_exact_f1"], counts["jac_add_f1"], counts["jac_dbl_f1"]) == (1, 0, 1)
    assert (counts["f2sqr"], counts["f2mul"], counts["ratio_chain"]) == {
        128: (45, 165, 1), 1024: (51, 183, 1)}[bucket]
    assert (counts["canonical"], counts["canon_reduce"]) == ({128: 36, 1024: 42}[bucket], 0)
    assert sum(counts.values()) == {128: 1084, 1024: 1123}[bucket]
    budgets = json.loads((REPO / "tests" / "budgets" / "kernel_costs.json").read_text())
    ref_total = budgets["buckets"][str(bucket)]["kernel_dispatches"]
    assert sum(REFERENCE[bucket].values()) == ref_total
    folded = sum(n * (sum(CHAIN_LAUNCHES[c].values()) - 1) for c, n in CHAINS_PER_VERIFY.items())
    folded += EXACT_ADDS_PER_VERIFY * (sum(EXACT_ADD.values()) - 1)
    assert sum(counts.values()) == ref_total - folded


# ------------------------------------------------ crypto_heavy


@pytest.mark.crypto_heavy
def test_local_phase_equals_reference_limbs():
    import jax.numpy as jnp

    from lighthouse_tpu.crypto.bls.backends import tpu as ref_tpu

    sets, rs = make_sets(4), SCALARS
    args = packed(sets, rs, lanes=4)
    got = CB.local_phase(*args)
    want = ref_tpu.local_phase(*(jnp.asarray(a.numpy()) for a in args))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1], want[1], strict=True):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2]) is bool(want[2]) is True


def _non_subgroup_point():
    from lighthouse_tpu_torch.crypto.bls import fields as F

    x = (1, 0)
    while True:
        y = F.f2sqrt(F.f2add(F.f2mul(F.f2sqr(x), x), C._B2))
        if y is not None and not C.g2_subgroup_check((x, y)):
            return (x, y)
        x = (x[0] + 1, 0)


@pytest.mark.crypto_heavy
def test_backend_matrix_on_cut_lanes():
    """Every case of tests/test_tpu_backend.py: the device verdict on the
    real lanes against the cpu backend on the same scalars."""
    rng = np.random.default_rng(3)

    def check(sets, want):
        rs = [int.from_bytes(rng.bytes(8), "big") | 1 for _ in sets]
        assert verify_cut(sets, rs) is want
        assert CPU.verify_signature_sets(sets, rs) is want

    check(make_sets(5), True)
    sets = make_sets(5)
    evil = SecretKey.from_seed(b"evil-key")
    sets[2] = SignatureSet.single_pubkey(
        evil.sign(b"wrong message"), sets[2].signing_keys[0], sets[2].message)
    check(sets, False)
    sks = [SecretKey.from_seed(bytes([i, 9, 9])) for i in range(1, 4)]
    msg = b"aggregate me"
    pks = [sk.public_key() for sk in sks]
    agg = bls.aggregate_signatures([sk.sign(msg) for sk in sks])
    check([SignatureSet.multiple_pubkeys(agg, pks, msg)] + make_sets(2), True)
    agg_bad = bls.aggregate_signatures([sk.sign(msg) for sk in sks[:2]])
    check([SignatureSet.multiple_pubkeys(agg_bad, pks, msg)], False)
    one = make_sets(1)[0]
    check([], False)
    check([SignatureSet(signature=one.signature, signing_keys=[], message=b"x")], False)
    check([SignatureSet.single_pubkey(Signature(point=None), one.signing_keys[0], one.message)],
          False)
    sets = make_sets(2)
    sets[1] = SignatureSet.single_pubkey(
        Signature(point=_non_subgroup_point()), sets[1].signing_keys[0], sets[1].message)
    check(sets, False)
    sk = SecretKey.from_seed(b"single")
    sig = sk.sign(b"hello")
    for m, want in ((b"hello", True), (b"goodbye", False)):
        s = [SignatureSet.single_pubkey(sig, sk.public_key(), m)]
        assert verify_cut(s, [1]) is want
        assert CPU.verify_single(sig, sk.public_key(), m) is want


@pytest.mark.crypto_heavy
def test_batch_through_reference_seam(monkeypatch):
    """The reference front's verify_signature_sets with the port registered
    as backend "cuda" (on the CPU, its batches cut to their real lanes);
    the reference's dispatch hook raises, so no reference kernel runs."""
    import lighthouse_tpu.crypto.bls as ref_bls
    from lighthouse_tpu.crypto.bls import backends as ref_backends
    from lighthouse_tpu.ops.lane import fp as ref_fp

    def no_reference_kernel(name, *a):
        raise AssertionError(f"reference kernel {name} dispatched")

    port = SimpleNamespace(
        verify_signature_sets=lambda sets, rs: CB.verify_signature_sets(sets, rs, device="cpu"),
        verify_single=lambda sig, pk, m: CB.verify_single(sig, pk, m, device="cpu"),
    )
    monkeypatch.setitem(ref_backends._BACKENDS, "cuda", port)
    monkeypatch.setattr(ref_fp, "CENSUS", no_reference_kernel)
    monkeypatch.setattr(params, "lane_bucket", lambda n: n)
    assert ref_bls.verify_signature_sets(make_sets(2), backend="cuda") is True
