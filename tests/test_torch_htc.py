"""The port's hash-to-G2 (host and lane-major) against the JAX reference.

The host modules (the isogeny coefficients, `hash_to_curve`) and the packed
constants of ops/lane/htc.py, the psi constants and the verify constants
are pinned equal to the reference's (through `convert`); the vectorized
packer is bit-identical to `fp.pack` and to the reference's; the draws the
host feeds the device equal the reference's limb for limb; and the lane map
`hash_draws_to_g2` of two messages equals the host `hash_to_g2`.
`crypto_heavy`: the ratio chain (one kernel in the port, `f2sqr` and
`f2mul` launches in a scan in the reference) limb for limb against the
reference's, jitted on CPU XLA.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import _g2_isogeny_consts as ref_iso
from lighthouse_tpu.crypto.bls import hash_to_curve as ref_h2c
from lighthouse_tpu.ops.lane import fastpack as ref_fastpack
from lighthouse_tpu.ops.lane import htc as ref_htc
from lighthouse_tpu.ops.lane import jacobian as ref_jac
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto.bls import _g2_isogeny_consts as iso
from lighthouse_tpu_torch.crypto.bls import hash_to_curve as h2c
from lighthouse_tpu_torch.crypto.bls.params import P
from lighthouse_tpu_torch.crypto.bls.backends import cuda as CB
from lighthouse_tpu_torch.ops.lane import fastpack, fp, htc, jacobian as J

MSGS = [b"", b"abc", b"msg-1"]


@pytest.mark.crypto_heavy
def test_ratio_chain_equals_reference_limb_for_limb():
    """`htc.ratio_chain` (its plain body on CPU tensors) against the
    reference's `ratio_chain` on the same seeded standard operands, 3 lanes
    and lane 0 zero; the reference's scan takes ~12 s to compile."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(98)
    w = rng.integers(0, 1 << fp.B, (2, fp.W, 3), dtype=np.int32)
    w[..., 0] = 0
    got = htc.ratio_chain(torch.from_numpy(w))
    want = np.asarray(jax.jit(ref_htc.ratio_chain)(jnp.asarray(w)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_host_modules_equal_reference():
    for name in ("XNUM", "XDEN", "YNUM", "YDEN", "KERNEL_X"):
        assert getattr(iso, name) == getattr(ref_iso, name)
    for m in MSGS:
        assert h2c.hash_to_field_fp2(m, 2) == ref_h2c.hash_to_field_fp2(m, 2)
    assert h2c.hash_to_g2(b"abc") == ref_h2c.hash_to_g2(b"abc")


def test_constants_equal_reference():
    from lighthouse_tpu.crypto.bls.backends import tpu as ref_tpu

    arrays = {name: getattr(ref_htc, name) for name in (
        "_A", "_B", "_Z", "_NEG_B", "_ZA", "_Z3", "_C2", "_ROOTS",
        "_ISO_XNUM", "_ISO_XDEN", "_ISO_YNUM", "_ISO_YDEN", "_E1", "_E0", "_WIN_IDX")}
    arrays["_PSI_CX"], arrays["_PSI_CY"] = ref_jac._psi_consts()
    arrays["_G1_GEN_NEG_X"] = ref_tpu._G1_GEN_NEG_X
    arrays["_G1_GEN_NEG_Y"] = ref_tpu._G1_GEN_NEG_Y
    ref = convert.htc_constants_from_reference(arrays)
    port = {name: torch.from_numpy(getattr(htc, "_" + name)) for name in (
        "A", "B", "Z", "NEG_B", "ZA", "Z3", "C2", "ROOTS")}
    for name in ("ISO_XNUM", "ISO_XDEN", "ISO_YNUM", "ISO_YDEN"):
        port[name] = torch.stack([torch.from_numpy(a) for a in getattr(htc, "_" + name)])
    port["E1"], port["E0"], port["WIN_IDX"] = htc._E1, htc._E0, htc._WIN_IDX
    port["PSI_CX"], port["PSI_CY"] = (torch.from_numpy(J.PSI_CX), torch.from_numpy(J.PSI_CY))
    port["G1_GEN_NEG_X"] = torch.from_numpy(CB._G1_GEN_NEG_X)
    port["G1_GEN_NEG_Y"] = torch.from_numpy(CB._G1_GEN_NEG_Y)
    assert sorted(port) == sorted(ref)
    for name, want in ref.items():
        got = port[name]
        if isinstance(want, torch.Tensor):
            assert got.dtype == torch.int32 and torch.equal(got, want), name
        else:
            assert got == want, name


def test_fastpack_bit_identical():
    rng = np.random.default_rng(11)
    vals = [0, 1, P - 1, 2**380 + 12345] + [
        int.from_bytes(rng.bytes(48), "big") % P for _ in range(60)
    ]
    got = fastpack.pack_ints(vals)
    assert got.dtype == np.int32
    assert np.array_equal(got, fp.pack(vals))
    assert np.array_equal(got, ref_fastpack.pack_ints(vals))
    pairs = list(zip(vals[::2], vals[1::2]))
    assert np.array_equal(fastpack.f2_pack_many(pairs), ref_fastpack.f2_pack_many(pairs))
    assert fastpack.pack_ints([]).shape == (fp.W, 0)


def test_draws_equal_reference():
    t0, t1 = htc.pack_draws(MSGS + [b"abc"])
    r0, r1 = ref_htc.pack_draws(MSGS + [b"abc"])
    assert t0.dtype == np.int32 and t0.shape == (2, fp.W, 4)
    assert np.array_equal(t0, np.asarray(r0)) and np.array_equal(t1, np.asarray(r1))


def test_hash_draws_to_g2_equals_host():
    msgs = [b"abc", b"msg-1"]
    t0, t1 = (torch.from_numpy(a) for a in htc.pack_draws(msgs))
    q = htc.hash_draws_to_g2(t0, t1)
    assert J.unpack_g2(q) == [h2c.hash_to_g2(m) for m in msgs]
