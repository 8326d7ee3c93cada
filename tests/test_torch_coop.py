"""The cooperative kernels' programs (lighthouse_tpu_torch/ops/lane/coop.py).

`miller_dbl_iter` and `cyc_sqr` run on the card as programs of warp jobs
(csrc/coop.cuh), traced from their plain bodies. Here each encoded program
is executed on CPU tensors job by job with the plain Fp bodies, stage by
stage with its row reuse, and held limb for limb against the plain body it
was traced from; the generated header that compiles the programs in, and
the word layout and the warps per element that the CUDA sources mirror,
are pinned to the Python side. The kernels themselves are held on the card
by chip_smoke.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.ops.lane import coop, fp, pairing

CSRC = Path(coop.__file__).resolve().parents[2] / "csrc"
F2, F12 = (2,), (2, 3, 2)

# kernel -> (plain body, operand fields, lazy terms per operand, products)
BODIES = {
    "miller_dbl_iter": (pairing._dbl_iter_body, [F12, F2, F2, F2, (), ()],
                        [3, 1, 1, 2, 1, 1], 106),
    "cyc_sqr": (pairing._cyc_sqr_body, [F12], [3], 18),
}


def lazy(rng, lead, comp, S, terms):
    shape = (*lead, *comp, fp.W, S)
    out = np.zeros(shape, np.int32)
    for _ in range(terms):
        out += int(rng.choice([-1, 1])) * rng.integers(0, 1 << fp.B, shape, dtype=np.int32)
    return torch.from_numpy(out)


def rows(t, lead):
    """[*lead, *comp, W, S] -> rows [comp rows, W, K * S] (stack on lanes)."""
    t = t.reshape(int(np.prod(lead, dtype=np.int64)), -1, fp.W, t.shape[-1])
    return t.permute(1, 2, 0, 3).reshape(t.shape[1], fp.W, -1)


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


@pytest.mark.parametrize("name", sorted(BODIES))
def test_program_shape(name):
    st = coop.stats(coop.slot(name))
    assert st["products"] == BODIES[name][3]
    assert st["words"] <= coop.MAX_WORDS
    assert st["smem_bytes"] <= 232_448  # a block's shared memory on Hopper


def _constexprs(text):
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_header_mirrors_python():
    hdr = _constexprs((CSRC / "coop.cuh").read_text())
    for key in ("MUL", "RL", "H_STAGES", "H_JOBS", "H_ROWS", "H_OUTS", "H_INS",
                "H_STAGE0", "JOB_WORDS", "OUT_WORDS", "SCRATCH"):
        assert hdr[key] == getattr(coop, key), key
    assert _constexprs((CSRC / "fp_lane.cuh").read_text())["NFOLD"] == coop.NFOLD
    miller = _constexprs((CSRC / "miller.cu").read_text())
    assert miller["DBL_WARPS"] == coop.PROGRAMS[coop.slot("miller_dbl_iter")][1]
    assert miller["CYC_WARPS"] == coop.PROGRAMS[coop.slot("cyc_sqr")][1]
    # the rows the kernels load and store (f, XT, YT, ZT, xP, yP -> f, X3,
    # Y3, Z3; f -> f), as miller.cu's static_asserts check them
    for name, n_in, n_out in (("miller_dbl_iter", 20, 18), ("cyc_sqr", 12, 12)):
        w = coop.program(coop.slot(name))
        assert (w[coop.H_INS], w[coop.H_OUTS]) == (n_in, n_out)


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


def test_tracing_leaves_other_callers_the_plain_bodies():
    mul_body, rl_body = fp._mul_body, fp._reduce_light_body
    c = fp.consts("cpu")
    a = lazy(np.random.default_rng(5), (), (), 2, 1)
    with coop._tracing():
        got = fp._mul_body(a, a, c["folds"], c["topf"]), fp._reduce_light_body(a, c["folds"], c["topf"])
    assert (fp._mul_body, fp._reduce_light_body) == (mul_body, rl_body)
    assert torch.equal(got[0], mul_body(a, a, c["folds"], c["topf"]))
    assert torch.equal(got[1], rl_body(a, c["folds"], c["topf"]))
