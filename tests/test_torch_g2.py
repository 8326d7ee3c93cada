"""The port's G2 Jacobian ops and windowed chains against their oracles.

The plain bodies of the `jac_dbl_f2`, `jac_add_f2`, `g1_win_step` and
`g2_win_step` kernels (lighthouse_tpu_torch/ops/lane/jacobian.py, chains.py)
are held against the host group law at canonical values on a few lanes,
infinity lanes and every window digit included; `jac_dbl_f2`, `jac_add_f2`
and `g2_win_step` limb for limb against the JAX reference's bodies run
eagerly on 2 x 8 lanes (every digit with infinity on either side); and,
`crypto_heavy`, all four against the reference's bodies, jitted. The glue around them
(`scalar_mul_static`, `psi`, `jac_eq`, the exact add and `lane_sum` over
Fp2, the windowed inversions and `scalar_mul_w2`) is held against the host
oracle. Tolerance everywhere: exact limbs or equal canonical values.
"""

import zlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.ops.lane import chains as ref_chains
from lighthouse_tpu.ops.lane import fp as ref_fp
from lighthouse_tpu.ops.lane import jacobian as ref_jac
from lighthouse_tpu_torch.crypto.bls import curve as C
from lighthouse_tpu_torch.crypto.bls import fields as F
from lighthouse_tpu_torch.crypto.bls.params import P, R, X
from lighthouse_tpu_torch.ops.lane import chains, fp, jacobian as J

G1, G2 = C.G1_GEN, C.G2_GEN
P1 = [C.g1_mul(G1, k) for k in (3, 5, 7, 11)]
P2 = [C.g2_mul(G2, k) for k in (3, 5, 7, 11)]
HOST = {
    1: SimpleNamespace(add=C.g1_add, dbl=C.g1_double, mul=C.g1_mul),
    2: SimpleNamespace(add=C.g2_add, dbl=C.g2_double, mul=C.g2_mul),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pack(nc, points):
    return J.pack_g1(points, "cpu") if nc == 1 else J.pack_g2(points, "cpu")


def unpack(nc, pt):
    return J.unpack_g1(pt) if nc == 1 else J.unpack_g2(pt)


def lazy_y(p):
    """The same points with a lazy Y: Y + p, limb by limb (2 units)."""
    X_, Y_, Z_ = p
    return X_, Y_ + torch.from_numpy(fp.to_limbs(P))[:, None], Z_


def jacobian_of(nc, points):
    """Standard-limb Jacobian operands with Z != 1: doubled, then halved
    back by the host (the doubling's outputs for points[i] / 2)."""
    half = (R + 1) // 2
    pre = [None if q is None else HOST[nc].mul(q, half) for q in points]
    return J.double(J.FP1 if nc == 1 else J.FP2, pack(nc, pre))


# ------------------------------------------------ bodies vs the host group law


@pytest.mark.parametrize("nc", [1, 2])
def test_dbl_body_equals_host(nc):
    pts = (P1 if nc == 1 else P2)[:3] + [None]
    op = J._dbl_f1 if nc == 1 else J._dbl_f2
    got = unpack(nc, op(*lazy_y(pack(nc, pts))))
    assert got == [HOST[nc].dbl(q) if q else None for q in pts]


@pytest.mark.parametrize("nc", [1, 2])
def test_add_body_equals_host_with_infinity_lanes(nc):
    base = P1 if nc == 1 else P2
    a = [base[0], None, base[2], None]
    b = [base[1], base[1], None, None]
    op = J._add_f1 if nc == 1 else J._add_f2
    got = unpack(nc, op(*lazy_y(pack(nc, a)), *jacobian_of(nc, b)))
    assert got == [HOST[nc].add(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("nc", [1, 2])
def test_win_step_body_equals_host_every_digit(nc):
    """acc <- [4]acc + T[digit] on 4 lanes, digits 0..3, the accumulator
    at infinity on lane 2 (the ladder's first windows)."""
    add, dbl, mul = HOST[nc].add, HOST[nc].dbl, HOST[nc].mul
    base = P1 if nc == 1 else P2
    acc = [base[3], base[2], None, base[0]]
    t = [base[1], dbl(base[1]), mul(base[1], 3)]
    t_lanes = [pack(nc, [t[k]] * 4) for k in range(3)]
    dig = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    op = chains._win_step["fp" if nc == 1 else "fp2"]
    got = unpack(nc, op(*jacobian_of(nc, acc), *t_lanes[0], *t_lanes[1], *t_lanes[2], dig))
    want = []
    for d, a in enumerate(acc):
        a4 = None if a is None else dbl(dbl(a))
        want.append(a4 if d == 0 else add(a4, t[d - 1]))
    assert got == want


# ------------------------------------------------ glue vs the host oracle


def test_exact_add_and_lane_sum_over_fp2():
    a = pack(2, [P2[0], P2[1], None, P2[3]])
    b = pack(2, [P2[0], C.g2_neg(P2[1]), P2[2], None])
    got = unpack(2, J.add(J.FP2, a, b, exact=True))
    assert got == [C.g2_double(P2[0]), None, P2[2], P2[3]]
    pts = [P2[0], P2[1], P2[0], C.g2_neg(P2[1]), P2[2]]
    want = None
    for q in pts:
        want = C.g2_add(want, q)
    assert unpack(2, J.lane_sum(J.FP2, pack(2, pts + [P2[3]]), 5)) == [want]


def test_static_ladder_psi_and_subgroup_equation():
    """[|u|]Q through scalar_mul_static, psi, and jac_eq's psi(Q) == -[|u|]Q
    (true on G2, false off it)."""
    from lighthouse_tpu_torch.crypto.bls import hash_to_curve as H2C

    m = -X
    q = pack(2, P2[:2] + [None])
    mq = J.scalar_mul_static(J.FP2, q, m)
    assert unpack(2, mq) == [C.g2_mul(P2[0], m), C.g2_mul(P2[1], m), None]
    assert unpack(2, J.psi(q)) == [C.psi(P2[0]), C.psi(P2[1]), None]
    # a point of E2 off G2: the isogeny image of one SSWU map, uncleared
    off = H2C.iso_map(H2C.map_to_curve_sswu((5, 7)))
    assert C.g2_on_curve(off) and not C.g2_subgroup_check(off)
    q = pack(2, [P2[2], off])
    ok = J.jac_eq(J.FP2, J.psi(q), J.neg(J.FP2, J.scalar_mul_static(J.FP2, q, m)))
    assert ok.tolist() == [True, False]


def test_windowed_inversions_equal_fermat():
    vals = [1, 2, P - 1, 0x1234_5678_9ABC_DEF0_1122]
    a = torch.from_numpy(fp.pack(vals))
    got = fp.unpack(fp.canonical(chains.inv(a)))
    assert got == [pow(v, P - 2, P) for v in vals]
    z = [(3, 4), (P - 1, 7), (0, 1)]
    packed = torch.stack([torch.from_numpy(fp.pack([c[k] for c in z])) for k in (0, 1)])
    inv2 = fp.canonical(chains.f2inv(packed)).numpy()
    assert [(fp.from_limbs(inv2[0, :, s]), fp.from_limbs(inv2[1, :, s])) for s in range(3)] == [
        F.f2inv(c) for c in z
    ]


def test_inv_w4_body_equals_the_windowed_loop():
    """`inv`'s one-kernel body makes `pow_const_w4(a, P - 2)`'s calls in
    its order: the same limbs, on a 2-unit lazy operand at 2 x 3 lanes."""
    rng = np.random.default_rng(zlib.crc32(b"inv_w4"))
    a = torch.from_numpy(rng.integers(0, 1 << fp.B, (2, fp.W, 3), dtype=np.int32)
                         - rng.integers(0, 1 << fp.B, (2, fp.W, 3), dtype=np.int32))
    c = fp.consts("cpu")
    assert torch.equal(chains._inv_w4_body(c["folds"], c["topf"], a), chains.pow_const_w4(a, P - 2))


@pytest.mark.crypto_heavy
def test_inv_w4_body_equals_reference_limb_for_limb():
    """`_inv_w4_body` against the reference's `chains.inv` (its windowed
    scan, jitted on CPU XLA) at 3 lanes of a 2-unit lazy operand."""
    rng = np.random.default_rng(zlib.crc32(b"inv_w4-ref"))
    a = (rng.integers(0, 1 << fp.B, (fp.W, 3), dtype=np.int32)
         - rng.integers(0, 1 << fp.B, (fp.W, 3), dtype=np.int32))
    c = fp.consts("cpu")
    got = chains._inv_w4_body(c["folds"], c["topf"], torch.from_numpy(a))
    assert np.array_equal(got.numpy(), np.asarray(jax.jit(ref_chains.inv)(jnp.asarray(a))))


@pytest.mark.parametrize("nc", [1, 2])
def test_scalar_mul_w2_equals_host(nc):
    mul = HOST[nc].mul
    base = (P1 if nc == 1 else P2)[:3]
    scalars = [0xFFFF_FFFF_FFFF_FFFF, 0x8000_0000_0000_0001, 6]
    bits = torch.from_numpy(J.scalars_to_bits(scalars, 64))
    got = unpack(nc, chains.scalar_mul_w2(J.FP1 if nc == 1 else J.FP2, pack(nc, base), bits))
    assert got == [mul(q, k) for q, k in zip(base, scalars)]


# ------------------------------------------------ limb for limb, eager


LEAD, LANES = (2,), 8
# every (digit, accumulator at infinity, entry at infinity) once
COMBOS = [(d, a, e) for d in range(4) for a in (0, 1) for e in (0, 1)]


def _eager_args(rng, name):
    """Operands on 2 x 8 lane elements, lane e of COMBOS[e]: the
    accumulator (P1) at infinity or not, the entry (P2: every table entry,
    the addend) at infinity or not, the window digit. Standard limbs, a
    lazy 2-unit Y1."""
    shape = (*LEAD, 2, fp.W, LANES)

    def canon():
        return rng.integers(0, 1 << fp.B, shape, dtype=np.int32)

    p1 = [canon(), canon() - canon(), canon()]
    n_other = {"jac_dbl_f2": 0, "jac_add_f2": 1, "g2_win_step": 3}[name]
    others = [[canon() for _ in range(3)] for _ in range(n_other)]
    dig = np.zeros((*LEAD, 1, LANES), np.int32)
    for e, (d, p1_inf, p2_inf) in enumerate(COMBOS):
        k, s = divmod(e, LANES)
        dig[k, 0, s] = d
        if p1_inf:
            p1[2][k, ..., s] = 0
        for pt in others:
            if p2_inf:
                pt[2][k, ..., s] = 0
    args = p1 + [c for pt in others for c in pt]
    return args + [dig] if name == "g2_win_step" else args


@pytest.mark.parametrize("name", ["jac_dbl_f2", "jac_add_f2", "g2_win_step"])
def test_bodies_equal_reference_eager(name):
    """The plain bodies the cooperative programs are traced from (and the
    add, split into `_add_core` and `_add_select`) against the reference's
    bodies run eagerly, as its own CPU tests run them, on `_eager_args`:
    infinity on either side and, for the window step, every digit."""
    rng = np.random.default_rng(zlib.crc32(b"eager-" + name.encode()))
    port_op, ref_fn = {
        "jac_dbl_f2": (J._dbl_f2, ref_jac._dbl_f2_body),
        "jac_add_f2": (J._add_f2, ref_jac._add_f2_body),
        "g2_win_step": (chains._win_step["fp2"], ref_chains._win_step_f2_body),
    }[name]
    args = _eager_args(rng, name)
    got = port_op(*(torch.from_numpy(a) for a in args))
    want = ref_fn(ref_fp._FOLDS, ref_fp._TOPFM, *map(jnp.asarray, args))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------ limb for limb, jitted


def _operands(rng, comp, S, n_points):
    shape = (*comp, fp.W, S)
    pts = []
    for i in range(n_points):
        for c in range(3):
            v = rng.integers(0, 1 << fp.B, shape, dtype=np.int32)
            if c == 1:  # a lazy 2-unit Y
                v = v - rng.integers(0, 1 << fp.B, shape, dtype=np.int32)
            if c == 2:
                v[..., (np.arange(S) + i) % 3 == 0] = 0  # infinity lanes
            pts.append(v)
    return pts


@pytest.mark.crypto_heavy
@pytest.mark.parametrize(
    "name", ["jac_dbl_f2", "jac_add_f2", "g1_win_step", "g2_win_step"]
)
def test_bodies_equal_reference_limb_for_limb(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    f2 = name != "g1_win_step"
    comp = (2,) if f2 else ()
    S = 4
    port_op, ref_fn, n_points = {
        "jac_dbl_f2": (J._dbl_f2, ref_jac._dbl_f2_body, 1),
        "jac_add_f2": (J._add_f2, ref_jac._add_f2_body, 2),
        "g1_win_step": (chains._win_step["fp"], ref_chains._win_step_f1_body, 4),
        "g2_win_step": (chains._win_step["fp2"], ref_chains._win_step_f2_body, 4),
    }[name]
    args = _operands(rng, comp, S, n_points)
    if n_points == 4:
        args.append(np.array([[0, 1, 2, 3]], dtype=np.int32))
    got = port_op(*(torch.from_numpy(a) for a in args))
    want = jax.jit(ref_fn)(
        jnp.asarray(ref_fp.FOLDS_NP), jnp.asarray(ref_fp.TOPFM_NP), *map(jnp.asarray, args)
    )
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))

