"""The port's lane-major G1 Jacobian ops against the JAX reference.

The plain bodies of the `jac_dbl_f1` / `jac_add_f1` kernels
(lighthouse_tpu_torch/ops/lane/jacobian.py) and of the exact add's one
kernel, `add_exact_f1`, must equal the reference's
(lighthouse_tpu/ops/lane/jacobian.py, whose exact add composes its check
around `jac_add_f1`) limb for limb, infinity lanes (Z = 0) and collisions
under different Z included; the exact add's H and R are the op-by-op
check's. Every reference call runs eagerly at one lane width, so its
per-shape compiles are paid once.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lighthouse_tpu.crypto.bls import curve as ref_curve
from lighthouse_tpu.ops.lane import jacobian as RJ
from lighthouse_tpu_torch.crypto.bls import curve as C
from lighthouse_tpu_torch.crypto.bls.params import G1X, G1Y, P
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


def jac_pt(points):
    """(affine point or None, Z) a lane -> (X, Y, Z) [W, n]: (x Z^2, y Z^3,
    Z); None: infinity, Z = 0."""
    xs, ys, zs = [], [], []
    for pt, z in points:
        x, y = (0, 0) if pt is None else pt
        z = 0 if pt is None else z
        xs.append(x * z * z % P)
        ys.append(y * z * z * z % P)
        zs.append(z)
    return tuple(torch.from_numpy(fp.pack(v)) for v in (xs, ys, zs))


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


def test_exact_add_collisions_equal_reference(monkeypatch):
    """P+P (doubling), P+(-P) (infinity), P+Q, inf+Q, P+inf, inf+inf on Z
    = 1; then under other Z: the same point under Z and under l Z (H === 0
    with its limbs not 0: the doubling), P + (-P) so (infinity), P + P
    under one Z != 1, P+Q, inf+Q. Through the one kernel's op
    (`add_exact_f1`, its plain body here) against the reference's op-by-op
    exact add."""
    calls = []
    monkeypatch.setattr(J.FP1, "add_exact", lambda *a: calls.append(1) or J._add_exact_f1(*a))
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
    z, lam = 0x1234_5678_9ABC_DEF0_1357, 0x2468_ACE0_FDB9_7531_0F0F
    a = jac_pt([(PTS[0], z), (PTS[1], z), (PTS[2], lam), (PTS[3], z), (PTS[4], lam), (None, z)])
    b = jac_pt([(PTS[0], z * lam), (C.g1_neg(PTS[1]), lam), (PTS[2], lam), (PTS[5], lam),
                (PTS[0], z), (PTS[5], z * lam)])
    assert not bool((a[0][:, 0] == b[0][:, 0]).all())  # other limbs, one point
    got = J.add(J.FP1, a, b, exact=True)
    assert_limbs_equal(got, RJ.add(RJ.FP1, ref_pt(a), ref_pt(b), exact=True))
    assert J.unpack_g1(got) == [
        C.g1_add(PTS[0], PTS[0]),
        None,
        C.g1_add(PTS[2], PTS[2]),
        C.g1_add(PTS[3], PTS[5]),
        C.g1_add(PTS[4], PTS[0]),
        PTS[5],
    ]
    assert len(calls) == 2 and not fp.LAUNCHES


def test_exact_add_check_is_the_adds_own_products():
    """`_add_exact_core_f1`'s H and R equal, limb for limb, the op-by-op
    check's mul(X2, Z1Z1) - mul(X1, Z2Z2) and mul(mul(Y2, Z1), Z1Z1) -
    mul(mul(Y1, Z2), Z2Z2); its sum and doubling are `_add_core_f1`'s and
    `_dbl_f1_body`'s, on lazy operands."""
    p1 = lazy_points()
    p2 = J._dbl_f1(*port_pt([PTS[5], None, PTS[2], PTS[3], None, PTS[1]]))
    (X1, Y1, Z1), (X2, Y2, Z2) = p1, p2
    c = fp.consts("cpu")
    out = J._add_exact_core_f1(c["folds"], c["topf"], *p1, *p2)
    assert len(out) == 8
    Z1Z1, Z2Z2 = fp.sqr(Z1), fp.sqr(Z2)
    assert torch.equal(out[6], fp.mul(X2, Z1Z1) - fp.mul(X1, Z2Z2))
    assert torch.equal(out[7], fp.mul(fp.mul(Y2, Z1), Z1Z1) - fp.mul(fp.mul(Y1, Z2), Z2Z2))
    for g, w in zip(out[:3], J._add_core_f1(c["folds"], c["topf"], *p1, *p2), strict=True):
        assert torch.equal(g, w)
    for g, w in zip(out[3:6], J._dbl_f1_body(c["folds"], c["topf"], *p1), strict=True):
        assert torch.equal(g, w)


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
