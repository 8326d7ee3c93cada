"""The per-lane dynamic ladders of the port against the JAX reference and
the host group law.

`ladder_step_f1` / `ladder_step_f2` (lighthouse_tpu_torch/ops/lane/
jacobian.py, the plain bodies of csrc/ladder.cu) must give the reference's
`_ladder_step_f*_body` limbs exactly, infinity lanes on both sides and
mixed bits included. `scalar_mul` and `scalar_mul_with_static` are held
against the host group law at canonical values, the static accumulator limb
for limb against `scalar_mul_static`, and their launches against the
reference's calls (one `ladder_step` per bit, one `add` per set static
bit). `crypto_heavy`: the reference's traced `scalar_mul` /
`scalar_mul_with_static` (lax.scan) limb for limb against the port.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.ops.lane import fp as ref_fp
from lighthouse_tpu.ops.lane import jacobian as ref_jac
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto.bls import curve as C
from lighthouse_tpu_torch.crypto.bls.params import X
from lighthouse_tpu_torch.ops.lane import fp, jacobian as J, kernels

U_ABS = -X  # |u|: 64 bits, 6 of them set
HOST = {1: C.g1_mul, 2: C.g2_mul}
BASES = {
    1: [C.g1_mul(C.G1_GEN, k) for k in (3, 5, 7, 11)],
    2: [C.g2_mul(C.G2_GEN, k) for k in (3, 5)],
}
SCALARS = [0xFFFF_FFFF_FFFF_FFFF, 0x8000_0000_0000_0001, 0x1234_5678_9ABC_DEF0, 0]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ops(nc):
    return J.FP1 if nc == 1 else J.FP2


def pack(nc, points):
    return J.pack_g1(points, "cpu") if nc == 1 else J.pack_g2(points, "cpu")


def unpack(nc, pt):
    return J.unpack_g1(pt) if nc == 1 else J.unpack_g2(pt)


def bits_of(scalars):
    return torch.from_numpy(J.scalars_to_bits(scalars, 64))


# ------------------------------------------------ one step, limb for limb


@pytest.mark.parametrize("nc", [1, 2])
def test_ladder_step_body_equals_reference(nc):
    """S = 4: lane 0 bit 1; lane 1 bit 0, addend at infinity; lane 2
    bit 1, accumulator at infinity; lane 3 bit 1, both at infinity."""
    rng = np.random.default_rng(160 + nc)
    shape = (*((2,) if nc == 2 else ()), fp.W, 4)

    def canon():
        return rng.integers(0, 1 << fp.B, shape, dtype=np.int32)

    acc = [canon(), canon() - canon(), canon()]   # a lazy 2-unit Y
    addend = [canon(), canon(), canon() + canon() - canon()]
    acc[2][..., [2, 3]] = 0
    addend[2][..., [1, 3]] = 0
    bit = np.array([[1, 0, 1, 1]], dtype=np.int32)
    args = [*acc, *addend, bit]
    ref_body = ref_jac._ladder_step_f1_body if nc == 1 else ref_jac._ladder_step_f2_body
    want = ref_body(ref_fp._FOLDS, ref_fp._TOPFM, *(jnp.asarray(a) for a in args))
    fp.reset_counts()
    got = (J._ladder_step_f1 if nc == 1 else J._ladder_step_f2)(*convert.lanes_from_reference(args))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))
    assert not fp.LAUNCHES and not fp.PLAIN_CUDA_CALLS


# ------------------------------------------------ the ladders, host group law


def test_scalar_mul_g1_equals_host():
    """Four lanes of 64-bit scalars, the full width, a zero scalar and an
    infinity base."""
    base = BASES[1][:2] + [None, BASES[1][3]]
    got = unpack(1, J.scalar_mul(J.FP1, pack(1, base), bits_of(SCALARS)))
    assert got == [None if q is None else C.g1_mul(q, k) for q, k in zip(base, SCALARS)]


def test_scalar_mul_with_static_g2_equals_host_and_static_ladder():
    """([k]Q, [|u|]Q) on two lanes of G2; the static accumulator is the
    limbs of `scalar_mul_static` (the same adds and doublings)."""
    q = pack(2, BASES[2])
    scalars = SCALARS[:2]
    dyn, stat = J.scalar_mul_with_static(J.FP2, q, bits_of(scalars), U_ABS)
    assert unpack(2, dyn) == [C.g2_mul(p, k) for p, k in zip(BASES[2], scalars)]
    assert unpack(2, stat) == [C.g2_mul(p, U_ABS) for p in BASES[2]]
    for a, b in zip(stat, J.scalar_mul_static(J.FP2, q, U_ABS), strict=True):
        assert torch.equal(a, b)


# ------------------------------------------------ launches per call


def _launches(fn) -> Counter:
    """Launches of fn() with every kernel replaced by a stand-in that
    returns zeros of its output shapes (the ladders' control flow does not
    depend on the values)."""
    counts = Counter()

    def stand_in(op, *arrays):
        counts[op.name] += 1
        _, ins, outs = kernels.ENTRIES[op.symbol]
        leads = [a.shape[: a.dim() - len(kernels._elem(k)) - 1] for a, k in zip(arrays, ins)]
        lead = torch.broadcast_shapes(*leads)
        lanes = max(a.shape[-1] for a in arrays)
        res = [torch.zeros((*lead, *c, fp.W, lanes), dtype=torch.int32) for c in outs]
        return res[0] if len(res) == 1 else tuple(res)

    mp = pytest.MonkeyPatch()
    mp.setattr(fp.KernelOp, "__call__", stand_in)
    try:
        fn()
    finally:
        mp.undo()
    return counts


@pytest.mark.parametrize("nc", [1, 2])
def test_launches_per_ladder(nc):
    """64 bits: 64 ladder steps; with the static |u| on the same chain,
    64 steps and popcount(|u|) = 6 adds."""
    base = tuple(ops(nc).zeros((), 8, "cpu") for _ in range(3))
    bits = torch.zeros(64, 8, dtype=torch.int32)
    step, add = f"ladder_step_f{nc}", f"jac_add_f{nc}"
    assert _launches(lambda: J.scalar_mul(ops(nc), base, bits)) == {step: 64}
    assert bin(U_ABS).count("1") == 6 and U_ABS.bit_length() == 64
    got = _launches(lambda: J.scalar_mul_with_static(ops(nc), base, bits, U_ABS))
    assert got == {step: 64, add: 6}


# ------------------------------------------------ crypto_heavy


@pytest.mark.crypto_heavy
@pytest.mark.parametrize("nc", [1, 2])
def test_ladders_equal_reference_limb_for_limb(nc):
    """The reference's scalar_mul and scalar_mul_with_static (lax.scan,
    traced) against the port at S = 4, limb for limb."""
    base_pts = (BASES[1] if nc == 1 else BASES[2] * 2)[:3] + [None]
    ref_pack = ref_jac.pack_g1 if nc == 1 else ref_jac.pack_g2
    ref_ops = ref_jac.FP1 if nc == 1 else ref_jac.FP2
    rbase = ref_pack(base_pts)
    rbits = jnp.asarray(J.scalars_to_bits(SCALARS, 64))
    base = convert.lanes_from_reference(rbase)
    bits = convert.lanes_from_reference([rbits])[0]
    got = J.scalar_mul(ops(nc), base, bits)
    want = ref_jac.scalar_mul(ref_ops, rbase, rbits)
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g.numpy(), np.asarray(w))
    got = J.scalar_mul_with_static(ops(nc), base, bits, U_ABS)
    want = ref_jac.scalar_mul_with_static(ref_ops, rbase, rbits, U_ABS)
    for gp, wp in zip(got, want, strict=True):
        for g, w in zip(gp, wp, strict=True):
            assert np.array_equal(g.numpy(), np.asarray(w))
