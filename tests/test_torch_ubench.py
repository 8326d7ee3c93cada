"""The port's Fp-product microbenchmark against the reference's.

lighthouse_tpu_torch/tools/ubench_mul.py keeps the reference's
(tools/ubench_pallas.py) round-2 product: its own FOLDS/TOPFM tables and a
3-pass carry normalization at every site. Its plain body, the yardstick of
csrc/ubench_mul.cu, must give the reference `_mul_body`'s limbs exactly,
single and chained, and the right products as Python ints. The reference
module parses sys.argv at import, so it is loaded from its file with the
arguments patched.
"""

import importlib.util
import random
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto.bls.params import P
from lighthouse_tpu_torch.ops.lane import fp
from lighthouse_tpu_torch.tools import ubench_mul as U

REF = Path(__file__).resolve().parents[1] / "tools" / "ubench_pallas.py"


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ubench_pallas_reference", REF)
    mod = importlib.util.module_from_spec(spec)
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", [str(REF)])
    try:
        spec.loader.exec_module(mod)
    finally:
        mp.undo()
    return mod


def test_tables_equal_reference(ref):
    got = convert.ubench_tables_from_reference(
        {"FOLDS": ref.FOLDS, "TOPFM": ref.TOPFM, "_TROW": ref._TROW}
    )
    assert np.array_equal(got["FOLDS"], U.FOLDS) and np.array_equal(got["TOPFM"], U.TOPFM)
    assert got["_TROW"] == U._TROW
    # the library copies them by pointer
    assert U.FOLDS.flags.c_contiguous and U.TOPFM.flags.c_contiguous
    assert U.FOLDS.dtype == U.TOPFM.dtype == np.int32
    assert (U.S_DEFAULT, U.R_DEFAULT) == (ref.S, ref.R) == (110592, 40)


@pytest.mark.parametrize("rounds", [1, 3])
def test_plain_body_equals_reference(ref, rounds):
    """8 lanes: the reference's single product (rounds = 1) or its chain
    x <- x b, on operands normed as its kernels norm them; the port's
    `mul` / `mul_chain` on the raw operands; then the values."""
    rnd = random.Random(2)
    ints_a = [rnd.randrange(P) for _ in range(8)]
    ints_b = [rnd.randrange(P) for _ in range(8)]
    a, b = fp.pack(ints_a), fp.pack(ints_b)
    a = a + a - fp.pack([rnd.randrange(P) for _ in range(8)])  # a lazy 3-unit a
    folds, topf = jnp.asarray(ref.FOLDS), jnp.asarray(ref.TOPFM)
    x, y = ref._norm3(jnp.asarray(a), topf), ref._norm3(jnp.asarray(b), topf)
    for _ in range(rounds):
        x = ref._mul_body(x, y, folds, topf)
    ta, tb = convert.lanes_from_reference([a, b])
    fp.reset_counts()
    got = U.mul(ta, tb) if rounds == 1 else U.mul_chain(ta, tb, rounds)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(x))
    want = [fp.from_limbs(a[:, s]) * pow(v, rounds, P) % P for s, v in enumerate(ints_b)]
    assert fp.unpack(got) == want
    assert fp.unpack(U.lane_chain(ta, tb, rounds)) == want
    assert not fp.LAUNCHES and not fp.PLAIN_CUDA_CALLS


def test_kernel_wrappers_refuse_wrong_arity():
    a = torch.zeros(fp.W, 2, dtype=torch.int32)
    with pytest.raises(TypeError):
        U.mul(a, a, 3)
    with pytest.raises(TypeError):
        U.mul_chain(a, a)
