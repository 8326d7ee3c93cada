"""The port's lane-major G1 Jacobian ops against the JAX reference.

The plain bodies of the `jac_dbl_f1` / `jac_add_f1` kernels
(lighthouse_tpu_torch/ops/lane/jacobian.py) and the exact add around them
must equal the reference's (lighthouse_tpu/ops/lane/jacobian.py) limb for
limb, infinity lanes (Z = 0) included. Every reference call runs eagerly at
one lane width, so its per-shape compiles are paid once.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lighthouse_tpu.crypto.bls import curve as ref_curve
from lighthouse_tpu.ops.lane import jacobian as RJ
from lighthouse_tpu_torch.crypto.bls import curve as C
from lighthouse_tpu_torch.crypto.bls.params import G1X, G1Y
from lighthouse_tpu_torch.ops.lane import fp, jacobian as J

G = (G1X, G1Y)
PTS = [C.g1_mul(G, k) for k in (3, 5, 7, 11, 13, 17)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_pt(points):
    return J.pack_g1(points, "cpu")


def ref_pt(p):
    return tuple(jnp.asarray(c.numpy()) for c in p)


def assert_limbs_equal(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


def lazy_points():
    """Six lanes: Z = 1 points, one with a lazy (negated) Y, one Z = 0."""
    X, Y, Z = port_pt(PTS[:5] + [None])
    Y = Y.clone()
    Y[:, 1] = -Y[:, 1]
    return X, Y, Z


def test_dbl_body_equals_reference():
    p = lazy_points()
    got = J._dbl_f1(*p)
    assert_limbs_equal(got, RJ._dbl_f1(*ref_pt(p)))
    affine = J.unpack_g1(got)
    assert affine[0] == C.g1_add(PTS[0], PTS[0]) and affine[5] is None
    assert not fp.LAUNCHES


def test_add_body_equals_reference_with_infinity_lanes():
    p1 = lazy_points()
    # standard-limb Jacobian operands with Z != 1: outputs of a doubling
    p2 = J._dbl_f1(*port_pt([PTS[5], None, PTS[2], PTS[3], None, None]))
    got = J._add_f1(*p1, *p2)
    assert_limbs_equal(got, RJ._add_f1(*ref_pt(p1), *ref_pt(p2)))
    q = [C.g1_add(a, a) if a else None for a in (PTS[5], None, PTS[2], PTS[3], None, None)]
    p1_aff = PTS[:1] + [C.g1_neg(PTS[1])] + PTS[2:5] + [None]
    want = [C.g1_add(a, b) for a, b in zip(p1_aff, q)]
    # lane 3 adds P3 to 2*P3 (no collision); lanes 1, 4, 5 select an input
    assert J.unpack_g1(got) == want


def test_exact_add_collisions_equal_reference():
    """P+P (doubling), P+(-P) (infinity), P+Q, inf+Q, P+inf, inf+inf."""
    a = port_pt([PTS[0], PTS[1], PTS[2], None, PTS[4], None])
    b = port_pt([PTS[0], C.g1_neg(PTS[1]), PTS[3], PTS[3], None, None])
    got = J.add(J.FP1, a, b, exact=True)
    want = RJ.add(RJ.FP1, ref_pt(a), ref_pt(b), exact=True)
    assert_limbs_equal(got, want)
    assert J.unpack_g1(got) == [
        C.g1_add(PTS[0], PTS[0]),
        None,
        C.g1_add(PTS[2], PTS[3]),
        PTS[3],
        PTS[4],
        None,
    ]


def test_lane_sum_five_points():
    """lane_sum over 5 lanes (padded to 8, three exact-add levels) equals
    the reference's host group law; the padding lanes enter as infinity."""
    pts = [PTS[0], PTS[1], PTS[0], C.g1_neg(PTS[1]), PTS[4]]
    X, Y, Z = port_pt(pts + [PTS[5]])  # lane 5 lies past n and is masked
    out = J.lane_sum(J.FP1, (X, Y, Z), 5)
    assert all(tuple(c.shape) == (fp.W, 1) for c in out)
    want = None
    for pt in pts:
        want = ref_curve.g1_add(want, pt)
    assert J.unpack_g1(out) == [want]
