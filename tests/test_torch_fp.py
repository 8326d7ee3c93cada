"""The port's lane-major Fp core against the JAX reference, limb for limb.

lighthouse_tpu_torch/ops/lane/fp.py keeps the reference's layout
([..., W=36, S] int32, signed lazy 11-bit limbs) and copies its carry
schedule, so both compute the same integers and every comparison here is
exact. The reference runs its jnp bodies eagerly on the CPU, as its own
tests do (off-TPU its kernel_op calls the body directly); the port runs
its plain PyTorch bodies, which a CPU tensor selects.
"""

import functools
import importlib.util
import random
import re
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lighthouse_tpu.ops import fp as ref_base
from lighthouse_tpu.ops.lane import fp as ref
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto.bls.params import P
from lighthouse_tpu_torch.ops import fp as port_base
from lighthouse_tpu_torch.ops.lane import fp as port

CUH = Path(port.__file__).resolve().parents[2] / "csrc" / "fp_lane.cuh"


@functools.cache
def _smoke():
    """chip_smoke.py, loaded from its file once (it holds canonical()'s
    edge and long-chain operands, which it runs on the card)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the bodies are many small ops: extra threads only contend
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lazy(rng, shape, terms=3):
    """Signed sums of up to `terms` canonical-limb elements: the lazy
    operands the kernels take, inside the certified entry intervals."""
    out = np.zeros(shape, np.int32)
    for _ in range(terms):
        out += int(rng.choice([-1, 1])) * rng.integers(0, 1 << port.B, shape, dtype=np.int32)
    return out


def test_constants_equal_reference():
    got = convert.constants_from_reference(
        {
            "FOLDS_NP": ref.FOLDS_NP,
            "TOPFM_NP": ref.TOPFM_NP,
            "KP_37": np.asarray(ref.KP_37),
            "PK_LADDER": np.asarray(ref.PK_LADDER),
            "_SCHED": ref._SCHED,
        }
    )
    # the CUDA libraries take the tables by pointer: they must be C-ordered
    assert port.FOLDS_NP.flags.c_contiguous and port.TOPFM_NP.flags.c_contiguous
    c = port.consts("cpu")
    assert torch.equal(got["FOLDS"], c["folds"])
    assert torch.equal(got["TOPFM"], c["topf"])
    assert torch.equal(got["KP_37"], c["kp37"][:, 0])
    assert torch.equal(got["PK_LADDER"], c["pk_ladder"][..., 0])
    assert got["SCHED"] == port._SCHED
    assert port._OPEN_SITES == ref._OPEN_SITES
    assert port._TROW == ref._TROW
    assert (port.B, port.W, port.MASK, port.CONVW, port.FOLD_AT) == (
        ref.B, ref.W, ref.MASK, ref.CONVW, ref.FOLD_AT
    )
    assert port_base._KP == ref_base._KP
    assert port._LADDER_ROUNDS == ref._LADDER_ROUNDS
    assert np.array_equal(port.ONE, ref.ONE) and np.array_equal(port.ZERO, ref.ZERO)


def test_cuda_header_depths_equal_schedule():
    """csrc/fp_lane.cuh carries the schedule as constants; they must be
    the copied _SCHED depths, site for site."""
    consts = dict(
        (m.group(1), int(m.group(2)))
        for m in re.finditer(r"constexpr int ([A-Z0-9_]+) = (\d+);", CUH.read_text())
    )
    for site in (
        "mul.entry_a", "mul.entry_b", "mul.wide", "mul.fold37", "mul.fold36",
        "mul.fold35", "sqr.entry", "rl.entry", "rl.fold_a", "rl.fold_b",
        "canon.entry", "canon.fold_a", "canon.fold_b", "canon.fold_c",
        "canon.fold_d", "norm3.kernel",
    ):
        name = site.replace(".", "_").upper()
        assert consts[name] == port._SCHED[site], site


def test_codec_roundtrips():
    rnd = random.Random(7)
    ints = [0, 1, P - 1, P, -1, 2**381] + [rnd.randrange(-P, 2 * P) for _ in range(20)]
    for x in ints:
        limbs = port.to_limbs(x)
        assert np.array_equal(limbs, ref_base.to_limbs(x))
        assert port.from_limbs(limbs) == x % P
    packed = port.pack(ints)
    assert packed.dtype == np.int32 and packed.shape == (port.W, len(ints))
    assert np.array_equal(packed, ref.pack(ints))
    assert port.unpack(torch.from_numpy(packed)) == [x % P for x in ints]
    stacked = torch.from_numpy(np.stack([packed, packed[:, ::-1].copy()]))
    assert port.unpack(stacked) == [x % P for x in ints + ints[::-1]]


@pytest.mark.parametrize("shape", [(36, 128), (2, 36, 5)])
@pytest.mark.parametrize("op", ["mul", "sqr", "canon_reduce"])
def test_plain_body_equals_reference(op, shape):
    rng = np.random.default_rng(zlib.crc32(f"{op}{shape}".encode()))
    args = [lazy(rng, shape) for _ in range(2 if op == "mul" else 1)]
    if op == "canon_reduce":  # eq_zero's input: a difference of products
        args = [lazy(rng, shape, terms=2)]
    port.reset_counts()
    got = getattr(port, op)(*(torch.from_numpy(a) for a in args))
    want = np.asarray(getattr(ref, op)(*(jnp.asarray(a) for a in args)))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), want)
    # a CPU tensor runs the plain body and launches nothing
    assert not port.LAUNCHES and not port.PLAIN_CUDA_CALLS


def test_canonical_and_eq_zero_match_python_ints():
    rnd = random.Random(11)
    xs = [rnd.randrange(P) for _ in range(7)] + [0, P - 1]
    ys = [rnd.randrange(P) for _ in range(7)] + [0, 1]
    a = torch.from_numpy(port.pack(xs))
    b = torch.from_numpy(port.pack(ys))
    diff = a - b + a  # a lazy sum of three standard elements
    want = [(2 * x - y) % P for x, y in zip(xs, ys)]
    assert torch.equal(port.canonical(diff), torch.from_numpy(port.pack(want)))
    assert port.unpack(port.canonical(diff)) == want
    # p itself (not reduced by the codec) is zero mod p
    p_raw = torch.from_numpy(port_base._limbs_raw(P, port.W))[:, None]
    zero_like = torch.cat([a - a, p_raw, a - b], dim=-1)
    got = port.eq_zero(zero_like).tolist()
    assert got == [True] * len(xs) + [True] + [x == y for x, y in zip(xs, ys)]
    assert port.eq(a, a).all() and not port.eq(a[:, :7], b[:, :7]).any()


def _canonical_operands(case):
    """canonical()'s held operands: seeded differences of products, the
    edges at both ends of the ladder's window, the long-chain lanes (offset
    value p * 2^k - 1, p * 2^k, p * 2^k + 1 for k = 0 .. 6) and the two
    lanes of limbs all MASK and all -MASK (chip_smoke.py builds the last
    three sets and holds the kernel on them)."""
    if case == "edges":
        return torch.from_numpy(_smoke()._canonical_edges())
    if case in ("chains", "all-mask"):
        cols = _smoke()._canonical_chains()
        return torch.from_numpy(cols[:, :21] if case == "chains" else cols[:, 21:])
    shape = (36, 8) if case == "products-36x8" else (2, 36, 4)
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    a, b, d, e = (torch.from_numpy(lazy(rng, shape)) for _ in range(4))
    return port.mul(a, b) - port.mul(d, e)


def _offsets(x) -> list:
    """The ladder's offset value v + KP of each lane (exact ints), v
    canon_reduce's output."""
    c = port.consts("cpu")
    v = port._canon_reduce_body(x, c["folds"], c["topf"])
    return [port_base._KP + sum(int(l) << (port.B * i) for i, l in enumerate(v[:, s]))
            for s in range(x.shape[-1])]


@pytest.mark.parametrize("case", ["products-36x8", "products-2x36x4", "edges", "chains",
                                  "all-mask"])
def test_canonical_plain_body_equals_reference(case):
    """The `canonical` kernel's plain body (canon_reduce, + KP and a
    ripple, the 7-round subtract ladder) against the reference's
    `canonical` limb for limb (exact), on seeded differences of products
    (the exact add's eq_zero operands), on the edge operands (whose last
    two lanes lie at the ends of the ladder's window), on the long chains
    (whose offset values are p * 2^k - 1, p * 2^k and p * 2^k + 1, so round
    k's difference carries through every limb) and on limbs all MASK and
    all -MASK; the limbs are the values mod p."""
    x = _canonical_operands(case)
    if case == "edges":
        low, high = _offsets(x)[5:]
        assert 0 < low < P and (P << 6) < high < (P << 7)
    if case == "chains":
        assert _offsets(x) == [(P << k) + d for k in range(port._LADDER_ROUNDS) for d in (-1, 0, 1)]
    port.reset_counts()
    got = port.canonical(x)
    want = np.asarray(ref.canonical(jnp.asarray(x.numpy())))
    assert got.dtype == torch.int32 and got.shape == x.shape
    assert np.array_equal(got.numpy(), want)
    assert port.unpack(got) == port.unpack(x)
    assert ((got >= 0) & (got <= port.MASK)).all()
    # a CPU tensor runs the plain body and launches nothing
    assert not port.LAUNCHES and not port.PLAIN_CUDA_CALLS


def _signed_ladder(x):
    """csrc/canon.cuh's `canonical_body` in its signed form, op for op on
    int32 tensors: canon_reduce, + KP and a ripple, then for k = 6 .. 0
    subtract p * 2^k where the value is >= 0 and add it where it is < 0
    (`(pk ^ flip) - flip`), the sign from the round's carry out; + p
    where the value ends < 0, and a last ripple."""
    c = port.consts("cpu")
    v = port._canon_reduce_body(x, c["folds"], c["topf"])
    v = port._ripple_carry(port._pad_limbs(v, 37) + c["kp37"])[0]
    neg = torch.zeros_like(v[..., :1, :])
    for k in reversed(range(port._LADDER_ROUNDS)):
        flip = neg - 1  # -1: subtract, 0: add
        v, carry = port._ripple_carry(v + ((c["pk_ladder"][k] ^ flip) - flip))
        neg = (carry[..., None, :] - neg < 0).to(torch.int32)
    v = port._ripple_carry(v + (c["pk_ladder"][0] & -neg))[0]
    return v[..., : port.W, :]


@pytest.mark.parametrize("case", ["products-36x8", "edges", "chains", "all-mask"])
def test_signed_ladder_equals_canonical(case):
    """The ladder's signed form, which `add_exact_f1` runs for its zero
    tests, gives the plain body's limbs on the operands canonical() is
    held on: seeded differences of products (H and R are such), the edge
    operands at both ends of the ladder's window, the long chains and
    limbs all MASK and all -MASK."""
    x = _canonical_operands(case)
    c = port.consts("cpu")
    assert torch.equal(_signed_ladder(x), port._canonical_fn(c["folds"], c["topf"], x))


@pytest.mark.parametrize("shape", [(36, 8), (2, 36, 4)])
def test_norm3_plain_body_equals_reference(shape):
    """The public carry reset on a 12-term lazy add chain (the depth the
    limb-bounds certificate covers at the norm3.kernel site)."""
    rng = np.random.default_rng(zlib.crc32(f"norm3{shape}".encode()))
    x = sum(lazy(rng, shape, terms=1) for _ in range(12))
    port.reset_counts()
    got = port.norm3(torch.from_numpy(x))
    want = np.asarray(ref.norm3(jnp.asarray(x)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert port.unpack(got) == port.unpack(x)
    assert not port.LAUNCHES and not port.PLAIN_CUDA_CALLS


def _header_constants(text):
    """The `constexpr int NAME = EXPR;` integers of a CUDA source, each
    EXPR evaluated over the ones before it (C's `/` on ints is `//`)."""
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        try:
            env[name] = int(eval(expr.replace("/", "//"), {}, dict(env)))
        except NameError:
            pass
    return env


@pytest.mark.parametrize("shape", [(36, 8), (2, 36, 4)])
def test_canon_reduce_model_over_the_blocks_packed_column(shape):
    """csrc/fp_lane.cuh's `g_short` image (KP | PK_LADDER | FOLDS column
    40 | TOPFM's row for 36 limbs, padded to whole int4s) laid out from the
    header's constants. `k_canon_reduce` (csrc/fp_canon.cu) copies its
    words [T_F40, T_TF) into the block and runs `canon_reduce_body<1>` over
    them: a numpy model of that body (open carry passes at the canon.*
    depths, four folds through the packed column) equals the plain body on
    seeded operands."""
    csrc = Path(port.__file__).resolve().parents[2] / "csrc"
    k = _header_constants((csrc / "fp_lane.cuh").read_text())
    assert (k["T_KP"], k["T_LADDER"], k["T_F40"], k["T_TF"], k["T_WORDS"]) == (0, 37, 296, 332, 368)
    assert k["T_F40"] % 4 == 0 and k["T_TF"] % 4 == 0
    img = np.zeros(k["T_WORDS"], np.int64)
    img[k["T_KP"] : k["T_LADDER"]] = port.KP_37
    img[k["T_LADDER"] : k["T_F40"]] = port.PK_LADDER.reshape(-1)
    img[k["T_F40"] : k["T_TF"]] = port.FOLDS_NP[:, 40]
    img[k["T_TF"] : k["T_TF"] + port.W] = port.TOPFM_NP[2, : port.W]
    src = re.sub(r"//[^\n]*", "", (csrc / "fp_canon.cu").read_text())
    body = src[src.index("k_canon_reduce(") : src.index("k_canonical(")]
    assert "lh::block_tables<lh::T_F40, lh::T_TF>()" in body
    assert "lh::canon_reduce_body<1>(v, f40)" in body
    f40 = img[k["T_F40"] : k["T_TF"]]  # the block's copy, stride 1

    def open_pass(x):  # norm1_open
        out = x & port.MASK
        out[1:] += x[:-1] >> port.B
        out[-1] += (x[-1] >> port.B) << port.B
        return out

    def fold(x):  # fold_col<1>
        out = np.zeros_like(x)
        out[: port.FOLD_AT] = x[: port.FOLD_AT]
        return out + f40[:, None] * x[port.FOLD_AT]

    rng = np.random.default_rng(zlib.crc32(f"canon_reduce{shape}".encode()))
    x = lazy(rng, shape, terms=2)
    flat = x.reshape(-1, port.W, shape[-1])
    got = []
    for v in flat.astype(np.int64):
        for _ in range(port._SCHED["canon.entry"]):
            v = open_pass(v)
        for site in ("canon.fold_a", "canon.fold_b", "canon.fold_c", "canon.fold_d"):
            v = fold(v)
            for _ in range(port._SCHED[site]):
                v = open_pass(v)
        got.append(v)
    want = port.canon_reduce(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.stack(got).reshape(shape), want)


def test_batch_inv_equals_reference():
    """K = 3 slots of S = 4 lanes, one slot zero on one lane: the
    reference's limbs, and the inverses (zero for zero) as Python ints."""
    rnd = random.Random(13)
    vals = [[rnd.randrange(1, P) for _ in range(4)] for _ in range(3)]
    vals[1][2] = 0
    a = np.stack([port.pack(v) for v in vals])
    got = port.batch_inv(torch.from_numpy(a))
    want = np.asarray(ref.batch_inv(jnp.asarray(a)))
    assert got.shape == (3, port.W, 4) and np.array_equal(got.numpy(), want)
    assert [port.unpack(got[k]) for k in range(3)] == [
        [pow(v, P - 2, P) for v in row] for row in vals
    ]


def test_inv_bin_body_equals_reference():
    """`fp.inv`'s one-kernel body (`pow_const`'s binary chain without the
    square after the last bit, whose result nothing reads) against the
    reference's `fp.inv` at 3 lanes of a 2-unit lazy operand, limb for
    limb; on a CPU tensor `inv` runs that body and launches nothing."""
    rng = np.random.default_rng(zlib.crc32(b"inv_bin"))
    a = lazy(rng, (port.W, 3), terms=2)
    c = port.consts("cpu")
    got = port._inv_bin_body(c["folds"], c["topf"], torch.from_numpy(a))
    assert np.array_equal(got.numpy(), np.asarray(ref.inv(jnp.asarray(a))))
    port.reset_counts()
    assert torch.equal(port.inv(torch.from_numpy(a)), got)
    assert not port.LAUNCHES and not port.PLAIN_CUDA_CALLS


def test_kernel_library_refuses_fortran_ordered_tables():
    """The libraries copy FOLDS/TOPFM, and fp_canon also KP_37 and
    PK_LADDER, by pointer: a table that is not C-ordered int32 (the
    concatenation of transposes comes out in Fortran order), or a missing
    one, is refused before anything is built or loaded."""
    from lighthouse_tpu_torch.ops.lane import kernels

    fortran = np.concatenate(
        [port_base.FOLD_FULL.T, port_base.FOLD_2.T, port_base.FOLD_1.T], axis=1
    ).astype(np.int32)
    assert not fortran.flags.c_contiguous
    with pytest.raises(ValueError, match="C-ordered int32"):
        kernels.load("fp_mul", fortran, port.TOPFM_NP)
    with pytest.raises(ValueError, match="C-ordered int32"):
        kernels.load("fp_mul", port.FOLDS_NP, port.TOPFM_NP.astype(np.int64))
    assert kernels.INIT_TABLES["fp_canon"] == ("KP_37", "PK_LADDER")
    assert port.KP_37.flags.c_contiguous and port.PK_LADDER.flags.c_contiguous
    for name, bad in (("PK_LADDER", np.asfortranarray(port.PK_LADDER)),
                      ("KP_37", port.KP_37.astype(np.int64))):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port, name, bad)
            with pytest.raises(ValueError, match="C-ordered int32"):
                kernels.load("fp_canon", port.FOLDS_NP, port.TOPFM_NP)
