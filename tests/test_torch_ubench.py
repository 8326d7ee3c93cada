"""The port's Fp-product microbenchmark against the reference's.

lighthouse_tpu_torch/tools/ubench_mul.py keeps the reference's
(tools/ubench_pallas.py) round-2 product: its own FOLDS/TOPFM tables and a
3-pass carry normalization at every site. Its plain body, the yardstick of
csrc/ubench_mul.cu, must give the reference `_mul_body`'s limbs exactly,
single and chained, and the right products as Python ints; the chain's
kernel reads the tables from a padded image in shared memory, whose layout
and a model of the fold over it are held here too. The reference module
parses sys.argv at import, so it is loaded from its file with the
arguments patched.
"""

import importlib.util
import random
import re
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


def _constexprs(text):
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = ([^;]+);", text)
            if v.strip().isdigit()}


def _table_image(fstride, tstride):
    """csrc/ubench_mul.cu `copy_prod_tables`: FOLDS [36, 41] with its rows
    padded to `fstride` words, then TOPFM [3, 73] with its rows padded to
    `tstride`; the pads 0."""
    img = np.zeros(fp.W * fstride + 3 * tstride, np.int32)
    img[: fp.W * fstride].reshape(fp.W, fstride)[:, : U.FOLDS.shape[1]] = U.FOLDS
    img[fp.W * fstride :].reshape(3, tstride)[:, : U.CONVW] = U.TOPFM
    return img


def test_chain_table_image_and_padded_fold():
    """The chain's tables in shared memory (csrc/ubench_mul.cu `g_prod`):
    FOLDS' rows padded from 41 to FSTRIDE words, TOPFM's from 73 to
    TSTRIDE, pads 0, as the source lays them out; every entry is FOLDS' or
    TOPFM's. A model of `SharedTables::fold` and `::pass` over that image,
    reading words as the kernel does (an int4 at a 16-byte-aligned offset
    where four are read, an int2 at an 8-byte-aligned one where two are),
    equals `_fold` and `_norm1` on seeded operands."""
    src = _constexprs((Path(U.__file__).resolve().parents[1] / "csrc" / "ubench_mul.cu")
                      .read_text())
    fstride, tstride = src["FSTRIDE"], src["TSTRIDE"]
    assert (fstride, tstride, src["P_FOLDS"]) == (44, 76, 0)
    p_topfm = fp.W * fstride
    img = _table_image(fstride, tstride)
    assert img.shape == (36 * 44 + 3 * 76,) and img.dtype == np.int32
    rows = img[:p_topfm].reshape(fp.W, fstride)
    tops = img[p_topfm:].reshape(3, tstride)
    for i in range(fp.W):
        for k in range(fstride):
            assert rows[i, k] == (U.FOLDS[i, k] if k < U.FOLDS.shape[1] else 0)
    for r in range(3):
        for k in range(tstride):
            assert tops[r, k] == (U.TOPFM[r, k] if k < U.CONVW else 0)

    widths = {"int4": 0, "int2": 0, "word": 0}

    def lds(off, n):  # the words the kernel's `lds` reads, and how
        if n == 4 and off % 4 == 0:
            widths["int4"] += 1
        elif n == 2 and off % 2 == 0:
            widths["int2"] += 1
        else:
            widths["word"] += n
        return img[off : off + n].astype(np.int64)

    def fold(x, n, off):  # SharedTables::fold<n, off>
        nk = n - U.FOLD_AT
        out = np.zeros((fp.W, x.shape[-1]), np.int64)
        for i in range(fp.W):
            s = x[i].copy() if i < U.FOLD_AT else np.zeros(x.shape[-1], np.int64)
            for k0 in range(0, nk, 4):
                f = lds(i * fstride + off + k0, min(4, nk - k0))
                for j, v in enumerate(f):
                    s += v * x[U.FOLD_AT + k0 + j]
            out[i] = s
        return out

    def norm_pass(x):  # SharedTables::pass<len(x)>
        n = x.shape[0]
        tf = np.concatenate([lds(p_topfm + U._TROW[n] * tstride + i0, min(4, n - i0))
                             for i0 in range(0, n, 4)])
        hi = x >> U.B
        out = (x & U.MASK) + tf[:, None] * hi[-1]
        out[1:] += hi[:-1]
        return out

    rng = np.random.default_rng(29)
    for n, off in ((U.CONVW, 0), (37, 38), (fp.W, 40)):
        x = rng.integers(-(1 << 12), 1 << 12, (n, 5), dtype=np.int32)
        want = U._fold(torch.from_numpy(x), torch.from_numpy(U.FOLDS[:, off : off + n - U.FOLD_AT]))
        assert np.array_equal(fold(x.astype(np.int64), n, off), want.numpy())
        got = norm_pass(x.astype(np.int64))
        assert np.array_equal(got, U._norm1(torch.from_numpy(x), torch.from_numpy(U.TOPFM)).numpy())
    # the folds read a 38-entry row as 9 int4s and an int2, a 2-entry row
    # as an int2, a 1-entry row as a word; a pass over 73, 37 and 36 limbs
    # reads 18, 9 and 9 int4s, the first two and a word
    assert widths == {"int4": 36 * 9 + 18 + 9 + 9, "int2": 36 + 36, "word": 36 + 2}


def test_both_kernels_read_the_one_shared_table_image():
    """csrc/ubench_mul.cu: `g_prod` is the library's only table image,
    copied into each block's shared memory, and no kernel reads the
    constant bank."""
    src = (Path(U.__file__).resolve().parents[1] / "csrc" / "ubench_mul.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    for bank in ("BankTables", "c_folds", "c_topfm", "copy_consts"):
        assert bank not in code
    assert re.findall(r"__device__ __align__\(16\) int (\w+)\[", code) == ["g_prod"]


def test_sweep_reads_each_kernels_own_ptxas_lines():
    """A ptxas -v log names both kernels mangled, k_ubench_mul a prefix of
    k_ubench_mul_chain: the sweep keeps each kernel's own two lines."""
    ns = "_ZN46_GLOBAL__N__f4092043_13_ubench_mul_cu_b4aeec8e"
    log = "\n".join([
        "ptxas info    : 8720 bytes gmem",
        f"ptxas info    : Function properties for {ns}18k_ubench_mul_chainEPKiS1_Piiii",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 253 registers, used 1 barriers, 7248 bytes smem",
        f"ptxas info    : Function properties for {ns}12k_ubench_mulEPKiS1_Piii",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 7248 bytes smem",
    ])
    assert U.kernel_ptxas(log) == {
        "ubench_mul_chain": ["0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                             "Used 253 registers, used 1 barriers, 7248 bytes smem"],
        "ubench_mul": ["8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
                       "Used 168 registers, used 1 barriers, 7248 bytes smem"]}
