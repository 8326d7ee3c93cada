"""The cooperative kernels' programs (lighthouse_tpu_torch/ops/lane/coop.py).

`miller_dbl_iter`, `miller_add_iter`, `cyc_sqr`, `jac_dbl_f1`,
`jac_add_f1`, `add_exact_f1`, `jac_dbl_f2`, `jac_add_f2`, `g1_win_step`,
`g2_win_step`, `f2mul`, `f2sqr`, `f6mul`, `f12mul`, `f12sqr`, the sparse
line product `f12mul_034`, the inversion chains
`inv_w4` and `inv_bin`, hash-to-G2's ratio chain (two programs, its table
and its window) and the standalone `mul` and `sqr` (one job each, one
warp per lane element) run
on the card as programs of warp jobs (csrc/coop.cuh), traced from their
plain bodies. Here each encoded program is executed on CPU tensors
job by job with the plain Fp bodies, stage by stage with its row reuse,
and held limb for limb against the plain body it was traced from; the
window steps' programs (their arithmetic without the selects), over G1
and G2, with their block-uniform epilogue against the whole plain body,
on every digit and infinity on either side, and `jac_add_f1`'s and
`jac_add_f2`'s with their epilogue against `_add_f1_body` and
`_add_f2_body`, with P1, P2, both or neither at infinity;
`add_exact_f1`'s with its epilogue (canonical() of H and R, the five-way
select) against `_add_exact_f1_body` on real points, every case of the
select taken; the per-lane ladder steps as their kernels compose the
add's and the doubling's programs with the infinity and bit selects,
against `_ladder_step_f1_body` and `_ladder_step_f2_body`; the ratio
chain's table program, then its window program once
a digit, against `_ratio_chain_body` and the op-by-op chain, whose value
is the host's w^((p^2 - 9) / 16).
A square is a job of its own kind, not a product of an operand with
itself (the two differ in limbs). The tracer refuses a select; the
generated header that compiles the programs in, the word layout, and the
slots and warps per element that the CUDA sources take from it, are
pinned to the Python side, as are tools/coop_warps.py's override of a warp
count and its comparison of a kernel's outputs with the plain body's. The
kernels themselves are held on the card by chip_smoke.py.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.crypto.bls import fields as FF
from lighthouse_tpu_torch.crypto.bls.params import P
from lighthouse_tpu_torch.ops.lane import (
    chains, coop, fp, htc, jacobian as J, kernels, pairing, tower,
)
from lighthouse_tpu_torch.tools import coop_warps, unfused_ms

CSRC = Path(coop.__file__).resolve().parents[2] / "csrc"
# chip_smoke.py, for the exact add's planted operands (real points)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
F2, F6, F12 = (2,), (3, 2), (2, 3, 2)

# kernel -> (plain body, operand fields, lazy terms per operand (ONE: the
# element 1, which the kernel writes), products and squares)
ONE = "one"
BODIES = {
    "miller_dbl_iter": (pairing._dbl_iter_body, [F12, F2, F2, F2, (), ()],
                        [3, 1, 1, 2, 1, 1], 106),
    # f, XT, YT, ZT, xQ, yQ, xP, yP -> f, X3, Y3, Z3
    "miller_add_iter": (pairing._add_iter_body, [F12, F2, F2, F2, F2, F2, (), ()],
                        [3, 1, 1, 2, 1, 1, 1, 1], 81),
    "cyc_sqr": (pairing._cyc_sqr_body, [F12], [3], 18),
    "jac_dbl_f1": (J._dbl_f1_body, [(), (), ()], [1, 2, 1], 7),
    "jac_dbl_f2": (J._dbl_f2_body, [F2, F2, F2], [1, 2, 1], 16),
    # the add's arithmetic: P1, P2 -> P1 + P2
    "jac_add_f1": (J._add_core_f1, [()] * 6, [1, 2, 1, 1, 1, 2], 16),
    "jac_add_f2": (J._add_core_f2, [F2] * 6, [1, 2, 1, 1, 1, 2], 43),
    # the exact add's arithmetic: P1, P2 -> P1 + P2, [2]P1, H, R
    "add_exact_f1": (J._add_exact_core_f1, [()] * 6, [1, 2, 1, 1, 1, 2], 23),
    "g1_win_step": (chains._win_core_f1, [()] * 6, [1, 2, 1, 1, 1, 1], 30),
    # the window step's arithmetic: acc, E -> [4]acc, [4]acc + E
    "g2_win_step": (chains._win_core_f2, [F2] * 6, [1, 2, 1, 1, 1, 1], 75),
    "f2mul": (tower._f2mul_body, [F2, F2], [3, 3], 3),
    "f2sqr": (tower._f2sqr_body, [F2], [3], 2),
    "f12mul": (tower._f12mul_body, [F12, F12], [3, 3], 54),
    "f6mul": (tower._f6mul_body, [F6, F6], [3, 3], 18),
    # a -> a^2; f, c0, c1, c4 -> f (c0 + c1 v + c4 v w): the unfused
    # Miller doubling's halves, f at the square's 4-unit output
    "f12sqr": (tower._f12sqr_body, [F12], [4], 36),
    "f12mul_034": (tower._f12mul_034_body, [F12, F2, F2, F2], [4, 1, 1, 1], 39),
    # one product: the standalone `mul`, laid out one warp per lane element;
    # one square: the standalone `sqr`, the same
    "mul": (fp._mul_fn, [(), ()], [3, 1], 1),
    "sqr": (fp._sqr_fn, [()], [3], 1),
    # a, 1 -> a^(p-2): 385 squares and 109 products; 380 and 229
    "inv_w4": (chains._inv_w4_body, [(), ()], [2, ONE], 494),
    "inv_bin": (fp._inv_bin_body, [(), ()], [2, ONE], 609),
    # the ratio chain: w, 1 -> its 16 entries; acc, E -> acc^4 E
    "ratio_table": (htc._ratio_table_body, [F2, F2], [1, ONE], 32),
    "ratio_win": (htc._ratio_win_body, [F2, F2], [1, 1], 7),
}
# the kernels' sources, by the program each launches
SOURCES = {"miller_dbl_iter": "miller.cu", "miller_add_iter": "miller.cu", "cyc_sqr": "miller.cu",
           "jac_dbl_f1": "jac_dbl.cu", "jac_add_f1": "jac_add.cu", "add_exact_f1": "jac_add.cu",
           "jac_dbl_f2": "jac_dbl.cu", "jac_add_f2": "jac_add.cu", "g1_win_step": "chains.cu",
           "g2_win_step": "chains.cu", "f12mul": "tower.cu", "inv_w4": "inv.cu",
           "inv_bin": "inv.cu", "ratio_table": "htc.cu", "ratio_win": "htc.cu",
           "f2mul": "tower.cu", "f2sqr": "tower.cu", "f6mul": "tower.cu", "mul": "fp_mul.cu",
           "f12sqr": "tower.cu", "f12mul_034": "tower.cu", "sqr": "fp_mul.cu"}
# the jobs of each stage, where a kernel's docstring states them
STAGE_JOBS = {"f2mul": [3, 2], "f2sqr": [2], "f6mul": [18, 12, 6], "f12mul": [54, 36, 18],
              "mul": [1], "f12sqr": [36, 24, 12], "f12mul_034": [39, 26], "sqr": [1]}


def lazy(rng, lead, comp, S, terms):
    shape = (*lead, *comp, fp.W, S)
    if terms == ONE:
        return fp.one_like(torch.zeros(shape, dtype=torch.int32)).contiguous()
    out = np.zeros(shape, np.int32)
    for _ in range(terms):
        out += int(rng.choice([-1, 1])) * rng.integers(0, 1 << fp.B, shape, dtype=np.int32)
    return torch.from_numpy(out)


def rows(t, lead):
    """[*lead, *comp, W, S] -> rows [comp rows, W, K * S] (stack on lanes)."""
    t = t.reshape(int(np.prod(lead, dtype=np.int64)), -1, fp.W, t.shape[-1])
    return t.permute(1, 2, 0, 3).reshape(t.shape[1], fp.W, -1)


def unrows(r, lead, comp, S):
    """The inverse of `rows`: [comp rows, W, K * S] -> [*lead, *comp, W, S]."""
    r = r.reshape(r.shape[0], fp.W, -1, S).permute(2, 0, 1, 3)
    return r.reshape(*lead, *comp, fp.W, S)


@pytest.mark.parametrize("name", sorted(BODIES))
def test_program_equals_plain_body(name):
    body, fields, terms, _ = BODIES[name]
    rng = np.random.default_rng(len(name) * 7919)
    lead, S = (2,), 3
    args = [lazy(rng, lead, comp, S, t) for comp, t in zip(fields, terms)]
    c = fp.consts("cpu")
    want = body(c["folds"], c["topf"], *args)
    want = want if isinstance(want, tuple) else (want,)
    got = coop.run_reference(coop.program(coop.slot(name)),
                             torch.cat([rows(a, lead) for a in args]), c["folds"], c["topf"])
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.cat([rows(w, lead) for w in want]))


def test_f2sqr_program_at_one_lane():
    """The standalone `f2sqr` at one lane element, as the final
    exponentiation's f6inv and the affine conversion of the signature
    aggregate call it: one stage of two products, limb for limb the plain
    body's."""
    body, fields, terms, _ = BODIES["f2sqr"]
    a = lazy(np.random.default_rng(29), (), fields[0], 1, terms[0])
    c = fp.consts("cpu")
    got = coop.run_reference(coop.program(coop.slot("f2sqr")), rows(a, ()),
                             c["folds"], c["topf"])
    assert torch.equal(got, rows(body(c["folds"], c["topf"], a), ()))
    st = coop.stats(coop.slot("f2sqr"))
    assert (st["stages"], st["jobs"], st["rows"]) == (1, 2, 4)


@pytest.mark.parametrize("name", ["g1_win_step", "g2_win_step"])
def test_win_step_program_with_epilogue_equals_plain_body(name):
    """A window step as its kernel computes it: the digit picks E
    (`_win_pick`), the program maps (acc, E) to ([4]acc, [4]acc + E), and
    the epilogue selects per lane element (`_win_select`). Every (digit,
    accumulator at infinity, entry at infinity) once, on 2 x 8 lane
    elements, over G1 and over G2."""
    f2 = name == "g2_win_step"
    comp, nc = (F2, 2) if f2 else ((), 1)
    rng = np.random.default_rng(2007)
    lead, S = (2,), 8
    acc = [lazy(rng, lead, comp, S, t) for t in (1, 2, 1)]
    table = [[lazy(rng, lead, comp, S, 1) for _ in range(3)] for _ in range(3)]
    dig = torch.zeros((*lead, 1, S), dtype=torch.int32)
    for e, (d, acc_inf, entry_inf) in enumerate(
            (d, a, b) for d in range(4) for a in (0, 1) for b in (0, 1)):
        k, s = divmod(e, S)
        dig[k, 0, s] = d
        if acc_inf:
            acc[2][k, ..., s] = 0
        if entry_inf:
            for t in table:
                t[2][k, ..., s] = 0
    c = fp.consts("cpu")
    body = chains._win_step_f2_body if f2 else chains._win_step_f1_body
    want = body(c["folds"], c["topf"], *acc, *table[0], *table[1], *table[2], dig)
    entry = chains._win_pick(dig, *table, f2)
    out = coop.run_reference(coop.program(coop.slot(name)),
                             torch.cat([rows(a, lead) for a in (*acc, *entry)]),
                             c["folds"], c["topf"])
    out = [unrows(out[nc * i : nc * (i + 1)], lead, comp, S) for i in range(6)]
    got = chains._win_select(dig, out[:3], entry, out[3:], f2)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["jac_add_f1", "jac_add_f2"])
def test_add_program_with_epilogue_equals_plain_body(name):
    """An add as its kernel computes it, over G1 and G2: the program maps
    (P1, P2) to the sum, and the epilogue selects per lane element
    (`_add_select`): P1, P2, both or neither at infinity, each on 2 x 3
    lane elements."""
    f2 = name == "jac_add_f2"
    comp, nc = (F2, 2) if f2 else ((), 1)
    rng = np.random.default_rng(2008)
    lead, S = (2,), 3
    p1 = [lazy(rng, lead, comp, S, t) for t in (1, 2, 1)]
    p2 = [lazy(rng, lead, comp, S, t) for t in (1, 1, 2)]
    for e, (inf1, inf2) in enumerate((a, b) for a in (0, 1) for b in (0, 1)):
        k, s = divmod(e, S)
        if inf1:
            p1[2][k, ..., s] = 0
        if inf2:
            p2[2][k, ..., s] = 0
    c = fp.consts("cpu")
    body = J._add_f2_body if f2 else J._add_f1_body
    want = body(c["folds"], c["topf"], *p1, *p2)
    out = coop.run_reference(coop.program(coop.slot(name)),
                             torch.cat([rows(a, lead) for a in (*p1, *p2)]),
                             c["folds"], c["topf"])
    total = [unrows(out[nc * i : nc * (i + 1)], lead, comp, S) for i in range(3)]
    got = J._add_select(p1, p2, total, f2)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_add_exact_program_with_epilogue_equals_plain_body(monkeypatch):
    """The exact add as its kernel computes it, on the smoke's planted
    lanes (real points: P + P under one Z and under Z2 = l Z1, P + (-P)
    both ways, infinity as P1, P2 and both, P + Q), a stack of 2 x 8: the
    program maps (P1, P2) to the sum, [2]P1, H and R; canonical() of H and
    R and the five-way select (`_add_exact_flags`, `_add_exact_select`)
    make the epilogue. Limb for limb `_add_exact_f1_body`, each case of the
    select taken."""
    monkeypatch.setattr(smoke, "DEVICE", "cpu")
    rng = np.random.default_rng(2009)
    args = smoke._inputs(rng, (2, fp.W, 8), "add_exact_f1")
    assert all(smoke.exact_branches(args).values())
    c = fp.consts("cpu")
    lead, S = (2,), 8
    out = coop.run_reference(coop.program(coop.slot("add_exact_f1")),
                             torch.cat([rows(a, lead) for a in args]), c["folds"], c["topf"])
    out = [unrows(out[i : i + 1], lead, (), S) for i in range(8)]
    flags = J._add_exact_flags(c["folds"], c["topf"], args[2], args[5], out[6], out[7])
    got = J._add_exact_select(args[:3], args[3:], out[:3], out[3:6], flags)
    want = J._add_exact_f1_body(c["folds"], c["topf"], *args)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["ladder_step_f1", "ladder_step_f2"])
def test_ladder_step_programs_with_selects_equal_plain_body(name):
    """A ladder step as its kernel (csrc/ladder.cu) computes it, over G1
    and G2: the add's program maps (acc, addend) to the sum and
    `_add_select` picks per lane element; where the bit is clear the
    kernel keeps the accumulator (it skips the add); the doubling's
    program maps the addend to its double. Bit rows 0, 1 and mixed, each
    with the accumulator, the addend, both or neither at infinity, on 2 x 3
    lane elements; limb for limb `_ladder_step_f1_body` / `_f2_body`."""
    f2 = name == "ladder_step_f2"
    comp, nc = (F2, 2) if f2 else ((), 1)
    add_name, dbl_name = coop.programs_of(name)
    assert (add_name, dbl_name) == (("jac_add_f2", "jac_dbl_f2") if f2
                                    else ("jac_add_f1", "jac_dbl_f1"))
    body = J._ladder_step_f2_body if f2 else J._ladder_step_f1_body
    rng = np.random.default_rng(2016)
    lead, S = (2,), 3
    c = fp.consts("cpu")

    def run(prog, pts):
        out = coop.run_reference(coop.program(coop.slot(prog)),
                                 torch.cat([rows(a, lead) for a in pts]), c["folds"], c["topf"])
        return [unrows(out[nc * i : nc * (i + 1)], lead, comp, S) for i in range(3)]

    mixed = torch.tensor([[[1, 0, 1]], [[0, 1, 0]]], dtype=torch.int32)
    for bit in (torch.zeros_like(mixed), torch.ones_like(mixed), mixed):
        acc = [lazy(rng, lead, comp, S, t) for t in (1, 2, 1)]
        addend = [lazy(rng, lead, comp, S, t) for t in (1, 1, 2)]
        for e, (inf1, inf2) in enumerate((a, b) for a in (0, 1) for b in (0, 1)):
            k, s = divmod(e, S)
            if inf1:
                acc[2][k, ..., s] = 0
            if inf2:
                addend[2][k, ..., s] = 0
        picked = J._add_select(acc, addend, run(add_name, (*acc, *addend)), f2)
        kept = [J._wh(bit[..., 0, :] != 0, p, a, nc) for p, a in zip(picked, acc)]
        got = (*kept, *run(dbl_name, addend))
        want = body(c["folds"], c["topf"], *acc, *addend, bit)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)


def _ratio_chain_by_launches(w):
    """The chain as `ratio_chain` ran it before it was one kernel: one
    `f2sqr` or `f2mul` call at a time (here their plain bodies)."""
    w1 = fp.norm3_x(w, site="htc.ratio_chain.entry")
    w2 = tower.f2sqr(w1)
    w3 = tower.f2mul(w2, w1)
    cw1, cw2, cw3 = (tower.f2conj(v) for v in (w1, w2, w3))
    pr = tower.f2mul(torch.stack([cw1, cw1, cw1, cw2, cw2, cw2, cw3, cw3, cw3]),
                     torch.stack([w1, w2, w3] * 3))
    one = torch.stack([fp.one_like(w1[..., 0, :, :]), torch.zeros_like(w1[..., 0, :, :])], -3)
    table = [one, w1, w2, w3, cw1, *pr[0:3], cw2, *pr[3:6], cw3, *pr[6:9]]
    acc = one
    for idx in htc._WIN_IDX:
        acc = tower.f2mul(tower.f2sqr(tower.f2sqr(acc)), table[idx])
    return acc


def test_ratio_chain_programs_equal_plain_body():
    """csrc/htc.cu's schedule on the CPU: the table program once, then the
    window program once a digit of _WIN_IDX, each window's acc the last
    output and its E the digit's entry, from entry 0; limb for limb
    `_ratio_chain_body`, which equals the chain launched op by op."""
    rng = np.random.default_rng(9)
    lead, S = (2,), 3
    w = lazy(rng, lead, F2, S, 1)
    c = fp.consts("cpu")
    want = htc._ratio_chain_body(c["folds"], c["topf"], w)
    assert torch.equal(want, _ratio_chain_by_launches(w))
    one = torch.stack([fp.one_like(w[..., 0, :, :]), torch.zeros_like(w[..., 0, :, :])], -3)
    table = coop.run_reference(coop.program(coop.slot("ratio_table")),
                               torch.cat([rows(w, lead), rows(one, lead)]), c["folds"], c["topf"])
    win = coop.program(coop.slot("ratio_win"))
    acc = table[0:2]
    for idx in htc._WIN_IDX:
        acc = coop.run_reference(win, torch.cat([acc, table[2 * idx : 2 * idx + 2]]),
                                 c["folds"], c["topf"])
    assert torch.equal(acc, rows(want, lead))


def test_ratio_chain_equals_host_power():
    """`ratio_chain` on CPU tensors (its plain body) is w^((p^2 - 9) / 16),
    the host's f2pow, on 3 lanes of 2 x 3 lazy operands."""
    rng = np.random.default_rng(10)
    lead, S = (2,), 3
    w = lazy(rng, lead, F2, S, 1)
    got = fp.canonical(htc.ratio_chain(w))
    e = (P * P - 9) // 16
    for k in range(lead[0]):
        for s in range(S):
            a = tuple(fp.from_limbs(w[k, i, :, s].numpy()) % P for i in range(2))
            want = FF.f2pow(a, e)
            assert tuple(fp.from_limbs(got[k, i, :, s].numpy()) for i in range(2)) == want


def test_square_is_a_job_kind_of_its_own():
    """`fp._sqr_fn` traces as one SQR job (one entry norm at sqr.entry),
    not as MUL(a, a) (two entry norms at mul.entry_*): on a 3-unit lazy
    operand the two programs give other limbs of the same value, and each
    equals the body it was traced from."""
    c = fp.consts("cpu")
    rng = np.random.default_rng(23)
    # three standard elements added (limbs to 3 x 2047), the top two limbs
    # set so that one carry pass leaves limb 35 above 11 bits: the second
    # pass of a product's entry folds it back mod p, a square's one does not
    a = torch.from_numpy(sum(rng.integers(0, 1 << fp.B, (fp.W, 4), dtype=np.int32)
                             for _ in range(3)))
    a[fp.W - 2], a[fp.W - 1] = 3 * fp.MASK, fp.MASK
    bodies = {"sqr": lambda folds, topf, x: fp._sqr_fn(folds, topf, x),
              "mul": lambda folds, topf, x: fp._mul_body(x, x, folds, topf)}
    got = {}
    for name, body in bodies.items():
        t, outs = coop.trace(body, (coop.FP,))
        assert [kind for kind, _, _ in t.jobs] == [coop.SQR if name == "sqr" else coop.MUL]
        got[name] = coop.run_reference(coop.encode(t, outs), a[None], c["folds"], c["topf"])[0]
        assert torch.equal(got[name], body(c["folds"], c["topf"], a))
    # the standalone `sqr`'s program (csrc/fp_mul.cu k_sqr) is that one job
    assert np.array_equal(coop.program(coop.slot("sqr")),
                          coop.encode(*coop.trace(bodies["sqr"], (coop.FP,))))
    assert not torch.equal(got["sqr"], got["mul"])
    assert fp.unpack(fp.canonical(got["sqr"])) == fp.unpack(fp.canonical(got["mul"]))


@pytest.mark.parametrize("body", ["add_f2", "where"])
def test_tracer_refuses_a_select(body):
    """The add's structural-infinity test (a comparison) and a torch.where
    on a traced value raise, naming the select."""
    fn, fields = {
        "add_f2": (J._add_f2_body, (coop.FP2,) * 6),
        "where": (lambda folds, topf, a, b: torch.where(torch.tensor(True), a, b),
                  (coop.FP, coop.FP)),
    }[body]
    with pytest.raises(ValueError, match="per-element select"):
        coop.trace(fn, fields)


@pytest.mark.parametrize("name", sorted(BODIES))
def test_program_shape(name):
    """Products, words, and a block's shared memory: the tables, a scratch
    a warp, and the rows (a PER_WARP kernel's: a set a warp, csrc/coop.cuh
    `warp_smem_ints`); the jobs of each stage where STAGE_JOBS states
    them (f6mul: its six f2muls' 18 products, their 12 reduce_lights, the
    output's 6)."""
    st = coop.stats(coop.slot(name))
    assert st["products"] == BODIES[name][3]
    assert st["words"] <= coop.MAX_WORDS
    assert st["smem_bytes"] <= 232_448  # a block's shared memory on Hopper
    sets = st["warps"] if name in coop.PER_WARP else 1
    assert st["smem_bytes"] == 4 * (coop.TABLES + st["warps"] * coop.SCRATCH
                                    + sets * st["rows"] * fp.W)
    if name in STAGE_JOBS:
        w = coop.program(coop.slot(name))
        starts = w[coop.H_STAGE0 : coop.H_STAGE0 + st["stages"] + 1]
        assert np.diff(starts).tolist() == STAGE_JOBS[name]


def test_programs_fit_the_constant_bank():
    """Every library that includes the generated header holds all programs
    and the ratio chain's digits in its constant bank, beside fp_lane.cuh's
    FOLDS and TOPFM. add_exact_f1's canonical() tables (KP and the ladder,
    37 + 7 x 37 words) stay out of the bank: jac_add.cu keeps them in
    global memory and copies them into the block's shared memory."""
    words = sum(coop.stats(slot)["words"] for slot in coop.PROGRAMS)
    digits = len(htc._WIN_IDX)
    assert words + digits + coop.TABLES <= coop.BANK_WORDS == 65536 // 4
    assert all(f"c_prog_{name}" in coop.header() for name, _ in coop.PROGRAMS.values())
    # with the ratio chain's table (399 words) and window (68), and its 191
    # digits, miller_add_iter's 978 words, f2mul's 42, f2sqr's 25,
    # jac_dbl_f1's 73, jac_add_f1's 125, add_exact_f1's 194, f6mul's 269,
    # mul's 15, f12sqr's 618, f12mul_034's 514 and sqr's 14: 13,295 words
    # of twenty-two programs, 15,181 of the bank's words with the digits
    # and the tables, 1,203 left
    assert (words, digits, coop.TABLES) == (
        11473 + 198 + 194 + 269 + 15 + 618 + 514 + 14, 191, 1695)
    assert words == 13295 and words + digits + coop.TABLES == 15181
    assert coop.BANK_WORDS - (words + digits + coop.TABLES) == 1203
    src = (CSRC / "jac_add.cu").read_text()
    assert "static __device__ int g_canon[CANON_WORDS];" in src and "__constant__" not in src
    fake = dict(coop.PROGRAMS)
    fake[22], fake[23] = ("inv_bin", 2), ("inv_bin", 2)  # 2 x 3,055 words more
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(coop, "PROGRAMS", fake)
        with pytest.raises(ValueError, match="overflow the constant bank"):
            coop.header()


def _constexprs(text):
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_header_mirrors_python():
    hdr = _constexprs((CSRC / "coop.cuh").read_text())
    for key in ("MUL", "RL", "SQR", "H_STAGES", "H_JOBS", "H_ROWS", "H_OUTS", "H_INS",
                "H_STAGE0", "JOB_WORDS", "OUT_WORDS", "SCRATCH"):
        assert hdr[key] == getattr(coop, key), key
    assert _constexprs((CSRC / "fp_lane.cuh").read_text())["NFOLD"] == coop.NFOLD
    # each kernel takes its slot and warps per element from the generated
    # header, which writes PROGRAMS', and hard-codes no warp count
    gen = _constexprs(coop.header())
    assert sorted(SOURCES) == sorted(n for n, _ in coop.PROGRAMS.values())
    for slot, (name, nw) in coop.PROGRAMS.items():
        key = name.upper()
        assert (gen[f"{key}_SLOT"], gen[f"{key}_WARPS"]) == (slot, nw)
        src = (CSRC / SOURCES[name]).read_text()
        assert f"lh::coop::{key}_WARPS" in src and f"lh::coop::{key}_SLOT" in src
        assert not re.search(r"constexpr int \w*WARPS = \d", src)
    # the rows the kernels load and store (f, XT, YT, ZT, xP, yP -> f, X3,
    # Y3, Z3; the same with xQ, yQ; f -> f; X, Y, Z -> X3, Y3, Z3 and P1,
    # P2 -> P1 + P2 over G1 and G2; acc, E -> [4]acc, [4]acc + E over G1
    # and G2; a, b -> a b over Fp, Fp2, Fp6 and Fp12; a -> a^2 over Fp2
    # and Fp12; f, c0, c1, c4 -> f (c0 + c1 v + c4 v w); a, 1 -> a^(p-2);
    # w, 1 -> 16 entries; acc, E -> acc^4 E), as the
    # sources' static_asserts check them
    for name, n_in, n_out in (("miller_dbl_iter", 20, 18), ("miller_add_iter", 24, 18),
                              ("f2mul", 4, 2), ("f2sqr", 2, 2), ("cyc_sqr", 12, 12),
                              ("jac_dbl_f1", 3, 3), ("jac_add_f1", 6, 3),
                              ("add_exact_f1", 6, 8),
                              ("jac_dbl_f2", 6, 6), ("jac_add_f2", 12, 6),
                              ("g1_win_step", 6, 6), ("g2_win_step", 12, 12),
                              ("f12mul", 24, 12), ("f6mul", 12, 6), ("mul", 2, 1), ("sqr", 1, 1),
                              ("f12sqr", 12, 12), ("f12mul_034", 18, 12),
                              ("inv_w4", 2, 1), ("inv_bin", 2, 1),
                              ("ratio_table", 4, 32), ("ratio_win", 4, 2)):
        w = coop.program(coop.slot(name))
        assert (w[coop.H_INS], w[coop.H_OUTS]) == (n_in, n_out)
    # the ladder steps run their programs on warps of their own, which
    # the header writes from LADDERS; ladder.cu takes them from it
    src = (CSRC / "ladder.cu").read_text()
    assert not re.search(r"constexpr int \w*WARPS = \d", src)
    for name, (progs, nw) in coop.LADDERS.items():
        assert gen[f"{name.upper()}_WARPS"] == nw
        assert f"lh::coop::{name.upper()}_WARPS" in src
        assert all(f"lh::coop::c_prog_{p}" in src for p in progs)


@pytest.mark.parametrize("name", sorted(BODIES))
def test_generated_header_holds_the_program(name):
    text = coop.header()
    w, key = coop.program(coop.slot(name)), name.upper()
    consts = _constexprs(text)
    assert (consts[f"{key}_ROWS"], consts[f"{key}_INS"], consts[f"{key}_OUTS"]) == (
        w[coop.H_ROWS], w[coop.H_INS], w[coop.H_OUTS])
    m = re.search(rf"__constant__ int c_prog_{name}\[(\d+)\] = \{{([^}}]*)\}};", text)
    assert int(m.group(1)) == len(w)
    assert [int(v) for v in m.group(2).replace(",", " ").split()] == w.tolist()


def test_header_holds_the_ratio_digits():
    """csrc/htc.cu's window digits: the generated `c_ratio_idx` is
    htc._WIN_IDX, most significant first, and RATIO_WINDOWS its length."""
    text = coop.header()
    m = re.search(r"__constant__ int c_ratio_idx\[(\d+)\] = \{([^}]*)\};", text)
    digits = [int(v) for v in m.group(2).replace(",", " ").split()]
    assert digits == [int(d) for d in htc._WIN_IDX] and int(m.group(1)) == len(digits) == 191
    assert _constexprs(text)["RATIO_WINDOWS"] == 191


def test_ratio_chain_kernel_stats():
    """The ratio chain's kernel: its table run and 191 window runs (1,771
    jobs: 1,369 products, 402 reduce_light; 769 stages), on the table
    program's 41 rows, which hold the window's 7 and the 32 entry rows."""
    st = coop.kernel_stats("ratio_chain")
    assert (st["jobs"], st["products"], st["stages"], st["rows"]) == (1771, 1369, 769, 41)
    assert st["smem_bytes"] == 4 * (coop.TABLES + st["warps"] * coop.SCRATCH + 41 * fp.W)
    assert coop.slot("ratio_chain") == coop.slot("ratio_table")


def test_tracing_leaves_other_callers_the_plain_bodies():
    mul_body, sqr_fn, rl_body = fp._mul_body, fp._sqr_fn, fp._reduce_light_body
    c = fp.consts("cpu")
    a = lazy(np.random.default_rng(5), (), (), 2, 1)
    with coop._tracing():
        got = (fp._mul_body(a, a, c["folds"], c["topf"]), fp._sqr_fn(c["folds"], c["topf"], a),
               fp._reduce_light_body(a, c["folds"], c["topf"]))
    assert (fp._mul_body, fp._sqr_fn, fp._reduce_light_body) == (mul_body, sqr_fn, rl_body)
    assert torch.equal(got[0], mul_body(a, a, c["folds"], c["topf"]))
    assert torch.equal(got[1], sqr_fn(c["folds"], c["topf"], a))
    assert torch.equal(got[2], rl_body(a, c["folds"], c["topf"]))


@pytest.mark.parametrize("name", ["g2_win_step", "ratio_chain", "add_exact_f1", "mul", "sqr",
                                  "ladder_step_f2"])
def test_warps_override_builds_apart_and_restores(name):
    """tools/coop_warps.py's variants: another warp count writes another
    header, so its library builds in a directory of its own; the count
    comes back after. The ratio chain's two programs move together; mul's
    and sqr's count is their warps a block, each warp with its own rows; a ladder
    step's count is its own, its programs' kernels keep theirs."""
    slots = [coop.slot(p) for p in coop.programs_of(name)]
    default, before = [coop.PROGRAMS[s] for s in slots], kernels.build_dir()
    ladder = coop.LADDERS.get(name)
    nw = 2 * (ladder[1] if ladder else default[0][1])
    with coop_warps.warps(name, nw):
        assert coop.kernel_stats(name)["warps"] == nw
        if ladder:
            assert f"constexpr int {name.upper()}_WARPS = {nw};" in coop.header()
            assert [coop.PROGRAMS[s] for s in slots] == default
        else:
            for s in slots:
                assert coop.stats(s)["warps"] == nw
                assert f"constexpr int {coop.PROGRAMS[s][0].upper()}_WARPS = {nw};" in coop.header()
        assert kernels.build_dir() != before
    assert [coop.PROGRAMS[s] for s in slots] == default and kernels.build_dir() == before
    assert coop.LADDERS.get(name) == ladder


def test_warps_tool_compares_one_output_and_several():
    """The tool holds a launch's outputs (a list) to the plain body's: a
    single tensor for a one-output kernel (cyc_sqr, f12mul, the
    inversions), a tuple for several; one changed limb is unequal."""
    a = lazy(np.random.default_rng(11), (), (), 3, 1)
    b = a.clone()
    b[0, 0] += 1
    assert coop_warps.equal_outputs([a.clone()], a)
    assert not coop_warps.equal_outputs([b], a)
    assert coop_warps.equal_outputs([a.clone(), b.clone()], (a, b))
    assert not coop_warps.equal_outputs([a.clone(), a.clone()], (a, b))
    assert not coop_warps.equal_outputs([a.clone()], (a, b))


def test_unfused_tool_holds_each_doubling(monkeypatch):
    """tools/unfused_ms.py's doublings on CPU tensors (the plain bodies):
    chained miller_dbl_iter from seeded operands, and each unfused
    f12mul_034(f12sqr(f), c0, c1, c4) torch.equal to its f; a changed limb
    of the line product raises."""
    monkeypatch.setattr(unfused_ms, "NDBL", 2)
    fused, unfused = unfused_ms.doubling_runs(2, device="cpu")
    got, want = unfused(), fused()
    assert len(got) == len(want) == 2
    assert all(torch.equal(g, w[0]) for g, w in zip(got, want, strict=True))
    m034 = tower.f12mul_034
    monkeypatch.setattr(tower, "f12mul_034", lambda *a: m034(*a) + 1)
    with pytest.raises(AssertionError, match="unfused doubling"):
        unfused_ms.doubling_runs(2, device="cpu")
