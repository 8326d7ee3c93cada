"""The port's lane-major Fp2/Fp6/Fp12 tower against the JAX reference.

The tower bodies (lighthouse_tpu_torch/ops/lane/tower.py, and
`reduce_light` of ops/lane/fp.py) keep the reference's layout, Karatsuba
stacks and lazy sums, so they must give the reference bodies' limbs
exactly; the reference bodies run jitted on the CPU (one XLA program each:
far cheaper here than op-by-op eager dispatch, and int32 arithmetic is
exact either way). The glue (inversions, Frobenius maps, conjugation) is
held against the reference's host field tower at canonical values, and the
constants against the reference's through `convert.tower_constants_from_reference`.
"""

import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import fields as ref_fields
from lighthouse_tpu.crypto.bls import pairing_fast as ref_pf
from lighthouse_tpu.ops.lane import fp as ref_fp
from lighthouse_tpu.ops.lane import pairing as ref_pairing
from lighthouse_tpu.ops.lane import tower as ref_tower
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto.bls.params import P
from lighthouse_tpu_torch.ops.lane import fp, pairing, tower

S = 3
LEAD = (2,)
F2, F6, F12 = (2,), (3, 2), (2, 3, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the bodies are many small ops: extra threads only contend
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lazy(rng, comp, terms=3):
    """Signed sums of up to `terms` canonical-limb elements of shape
    [*LEAD, *comp, W, S]: lazy operands inside the entry contracts."""
    shape = (*LEAD, *comp, fp.W, S)
    out = np.zeros(shape, np.int32)
    for _ in range(terms):
        out += int(rng.choice([-1, 1])) * rng.integers(0, 1 << fp.B, shape, dtype=np.int32)
    return out


def test_constants_equal_reference():
    got = convert.tower_constants_from_reference(
        {
            "F2_ONE": np.asarray(ref_tower.F2_ONE),
            "F12_ONE": np.asarray(ref_tower.F12_ONE),
            "_G1C": np.asarray(ref_tower._G1C),
            "_G2C": np.asarray(ref_tower._G2C),
            "_G3C": np.asarray(ref_tower._G3C),
            "_ATE_BITS": ref_pairing._ATE_BITS,
        }
    )
    mine = tower.consts("cpu")
    for name in ("f2_one", "f12_one", "g1c", "g2c", "g3c"):
        assert torch.equal(got[name], mine[name]), name
    assert got["ate_bits"] == pairing._ATE_BITS
    assert pairing._ATE_BITS.count(1) == 5 and len(pairing._ATE_BITS) == 63


# name -> (port op, reference body, operand fields, lazy terms per operand)
BODIES = {
    "reduce_light": (fp.reduce_light, ref_fp._reduce_light_fn, [F2], [4]),
    "f2mul": (tower.f2mul, ref_tower._f2mul_body, [F2, F2], [3, 3]),
    "f2sqr": (tower.f2sqr, ref_tower._f2sqr_body, [F2], [3]),
    "f6mul": (tower.f6mul, ref_tower._f6mul_body, [F6, F6], [3, 3]),
    "f12mul": (tower.f12mul, ref_tower._f12mul_body, [F12, F12], [3, 3]),
    "f12sqr": (tower.f12sqr, ref_tower._f12sqr_body, [F12], [4]),
    "f12mul_034": (tower.f12mul_034, ref_tower._f12mul_034_body,
                   [F12, F2, F2, F2], [4, 1, 1, 1]),
}


@pytest.mark.parametrize("name", list(BODIES))
def test_body_equals_reference_limb_for_limb(name):
    port_op, ref_body, fields, terms = BODIES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    args = [lazy(rng, comp, t) for comp, t in zip(fields, terms)]
    want = np.asarray(
        jax.jit(ref_body)(ref_fp._FOLDS, ref_fp._TOPFM, *(jnp.asarray(a) for a in args))
    )
    targs = [torch.from_numpy(a) for a in args]
    fp.reset_counts()
    if isinstance(port_op, fp.KernelOp):
        got = port_op(*targs)  # a CPU tensor selects the plain body
    else:
        c = fp.consts("cpu")
        got = port_op(c["folds"], c["topf"], *targs)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    assert not fp.LAUNCHES and not fp.PLAIN_CUDA_CALLS


def test_unfused_miller_doubling_equals_dbl_iter():
    """f12mul_034(f12sqr(f), c0, c1, c4) through the two standalone ops
    gives miller_dbl_iter's f, limb for limb, with the line coefficients
    of the doubling step on the same operands (S = 4)."""
    rng = np.random.default_rng(34)

    def canon(*comp):
        return rng.integers(0, 1 << fp.B, (*comp, fp.W, 4), dtype=np.int32)

    f = canon(*F12) + canon(*F12) - canon(*F12)  # a lazy 3-unit f
    args = [torch.from_numpy(a) for a in (f, canon(*F2), canon(*F2), canon(*F2), canon(), canon())]
    c = fp.consts("cpu")
    *_, c0, c1, c4 = pairing._dbl_step_body(c["folds"], c["topf"], *args[1:])
    fp.reset_counts()
    got = tower.f12mul_034(tower.f12sqr(args[0]), c0, c1, c4)
    want = pairing._dbl_iter(*args)[0]
    assert got.shape == want.shape and torch.equal(got, want)
    assert not fp.LAUNCHES and not fp.PLAIN_CUDA_CALLS


# ------------------------------------------------ glue at canonical values


def _rf2(rnd):
    return (rnd.randrange(P), rnd.randrange(P))


def _rf6(rnd):
    return tuple(_rf2(rnd) for _ in range(3))


def _rf12(rnd):
    return (_rf6(rnd), _rf6(rnd))


def _lanes(packed):
    """Per-lane packed [..., W, 1] arrays -> one tensor [..., W, n]."""
    return torch.from_numpy(np.concatenate(packed, axis=-1))


GLUE = {
    # name: (port function, host oracle, operand kind)
    "f2inv": (tower.f2inv, ref_fields.f2inv, "f2"),
    "f6inv": (tower.f6inv, ref_fields.f6inv, "f6"),
    "f12inv": (tower.f12inv, ref_fields.f12inv, "f12"),
    "frob1": (tower.frob1, lambda a: ref_pf.frob(a, 1), "f12"),
    "frob2": (tower.frob2, lambda a: ref_pf.frob(a, 2), "f12"),
    "frob3": (tower.frob3, lambda a: ref_pf.frob(a, 3), "f12"),
    "f12conj": (tower.f12conj, ref_fields.f12conj, "f12"),
}


def _canonical_lanes(a, kind):
    """Lane-major tower tensor -> one nested tuple of canonical ints per lane."""
    c = fp.canonical(a).numpy()

    def f2(x, s):
        return fp.from_limbs(x[0, :, s]), fp.from_limbs(x[1, :, s])

    def f6(x, s):
        return tuple(f2(x[i], s) for i in range(3))

    def f12(x, s):
        return tuple(f6(x[j], s) for j in range(2))

    return [{"f2": f2, "f6": f6, "f12": f12}[kind](c, s) for s in range(c.shape[-1])]


@pytest.mark.parametrize("name", list(GLUE))
def test_glue_equals_host_fields(name):
    fn, oracle, kind = GLUE[name]
    rnd = random.Random(zlib.crc32(name.encode()))
    vals = [{"f2": _rf2, "f6": _rf6, "f12": _rf12}[kind](rnd) for _ in range(2)]
    pack = {"f2": tower.f2_pack, "f6": tower.f6_pack, "f12": tower.f12_pack}[kind]
    x = _lanes([pack(v) for v in vals])
    fp.reset_counts()
    got = _canonical_lanes(fn(x), kind)
    assert got == [oracle(v) for v in vals]
    assert not fp.LAUNCHES


def test_inv_equals_fermat_pow():
    rnd = random.Random(5)
    xs = [rnd.randrange(1, P) for _ in range(3)] + [0, 1, P - 1]
    got = fp.unpack(fp.canonical(fp.inv(torch.from_numpy(fp.pack(xs)))))
    assert got == [pow(x, P - 2, P) for x in xs]
    assert pow(xs[0], P - 2, P) * xs[0] % P == 1


def test_f12_eq_one():
    one = torch.from_numpy(tower.F12_ONE)
    other = _lanes([tower.f12_pack(_rf12(random.Random(9)))])
    got = tower.f12_eq_one(torch.cat([one, other, one], -1))
    assert got.tolist() == [True, False, True]
