"""Device time of a cooperative kernel at several warps per lane element.

A cooperative kernel (csrc/coop.cuh) takes its warps per lane element from
ops/lane/coop.py PROGRAMS (a ladder step: LADDERS) through the generated
header. This tool builds the libraries once per warp count asked for (the
kernel's count replaced while the header is written, each build in its
own directory),
holds every variant's outputs torch.equal to the plain body on the same
seeded operands, then times the variants in turns (a b b a ..., the
profiler's device time of REPS launches each) and prints one JSON line per
variant with its rounds of jobs, its shared memory and the card.

Run on a machine with a CUDA card:

    python -m lighthouse_tpu_torch.tools.coop_warps g2_win_step --S 1024 --warps 4 8
    python -m lighthouse_tpu_torch.tools.coop_warps f12mul --S 1 512 --warps 8 16 32
    python -m lighthouse_tpu_torch.tools.coop_warps ratio_chain --S 1 256 2048 --warps 1 2 4
    python -m lighthouse_tpu_torch.tools.coop_warps miller_add_iter --S 1 2 1024 --warps 6 8 9 13
    python -m lighthouse_tpu_torch.tools.coop_warps f2mul --S 1 1024 2048 --K 1 4 --warps 1 2 3
    python -m lighthouse_tpu_torch.tools.coop_warps f2sqr --S 1 512 1024 2048 --warps 1 2 3
    python -m lighthouse_tpu_torch.tools.coop_warps jac_add_f1 --S 1 256 4096 --warps 2 3 4 5
    python -m lighthouse_tpu_torch.tools.coop_warps jac_dbl_f1 --S 1 1024 4096 --warps 1 2 3 4
    python -m lighthouse_tpu_torch.tools.coop_warps add_exact_f1 --S 1 2048 4096 --warps 3 4 5
    python -m lighthouse_tpu_torch.tools.coop_warps f6mul --S 1 1024 4096 --warps 6 9 12 16 18 32
    python -m lighthouse_tpu_torch.tools.coop_warps mul --S 1 1024 4096 --K 1 2 12 --warps 1 2 4 8 16
    python -m lighthouse_tpu_torch.tools.coop_warps sqr --S 1 128 1024 4096 --warps 1 2 4 8 16 32
    python -m lighthouse_tpu_torch.tools.coop_warps ladder_step_f2 --S 1024 4096 --warps 2 4 8
    python -m lighthouse_tpu_torch.tools.coop_warps f12sqr --S 1 128 1024 4096 --warps 8 16 32

Kernels: miller_dbl_iter, miller_add_iter, cyc_sqr, jac_dbl_f1,
jac_add_f1, add_exact_f1, jac_dbl_f2, jac_add_f2, g1_win_step,
g2_win_step, f2mul, f2sqr, f6mul, f12mul, f12sqr, f12mul_034, inv_w4,
inv_bin, ratio_chain
(its two programs on one warp count), mul and sqr, laid out one warp per
lane element (coop.PER_WARP: their warps a block, each on its own
element), and
the ladder steps ladder_step_f1 and ladder_step_f2 (coop.LADDERS: the
add's and the doubling's programs on a warp count of the step's own,
their kernels' counts untouched). Several widths (--S) and stack depths
(--K: operands [K, ..., S], K x S lane elements) share one build per warp
count. The seeded operands put no point at infinity; a ladder step's bit
is 0 or 1 at random, a window step's digit 0 to 3.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops.lane import chains, coop, fp, htc, jacobian as J, kernels, pairing, tower

REPS = 50


def _ops():
    return {"miller_dbl_iter": pairing._dbl_iter, "miller_add_iter": pairing._add_iter,
            "cyc_sqr": pairing.cyclotomic_sqr,
            "jac_dbl_f1": J._dbl_f1, "jac_add_f1": J._add_f1, "add_exact_f1": J._add_exact_f1,
            "jac_dbl_f2": J._dbl_f2, "jac_add_f2": J._add_f2,
            "g1_win_step": chains._win_step["fp"], "g2_win_step": chains._win_step["fp2"],
            "f2mul": tower.f2mul, "f2sqr": tower.f2sqr, "f6mul": tower.f6mul,
            "f12mul": tower.f12mul, "f12sqr": tower.f12sqr, "f12mul_034": tower.f12mul_034,
            "mul": fp.mul, "sqr": fp.sqr,
            "inv_w4": chains.inv_w4,
            "inv_bin": fp.inv_bin,
            "ratio_chain": htc.ratio_chain_op,
            "ladder_step_f1": J._ladder_step_f1, "ladder_step_f2": J._ladder_step_f2}


@contextlib.contextmanager
def warps(name: str, nw: int):
    """coop.PROGRAMS with `nw` warps per lane element for kernel `name`
    (for every program it runs); for a ladder step, coop.LADDERS' count,
    its programs' own left as they are."""
    if name in coop.LADDERS:
        old = coop.LADDERS[name]
        coop.LADDERS[name] = (old[0], nw)
        try:
            yield
        finally:
            coop.LADDERS[name] = old
        return
    slots = [coop.slot(p) for p in coop.programs_of(name)]
    old = {s: coop.PROGRAMS[s] for s in slots}
    for s in slots:
        coop.PROGRAMS[s] = (old[s][0], nw)
    try:
        yield
    finally:
        coop.PROGRAMS.update(old)


def operands(name: str, S: int, seed: int = 6, K: int = 1) -> list:
    """Seeded operands of kernel `name` on S lanes (a stack of K where K >
    1): standard limbs, one int32 per lane for a ROW operand (a ladder
    step's bit in 0..1, a window step's digit in 0..3)."""
    rng = np.random.default_rng(seed)
    _, ins, _ = kernels.ENTRIES[_ops()[name].symbol]
    lead = (K,) if K > 1 else ()
    out = []
    for kind in ins:
        if kind == kernels.ROW:
            a = rng.integers(0, 2 if name in coop.LADDERS else 4, (*lead, 1, S), dtype=np.int32)
        else:
            a = rng.integers(0, 1 << fp.B, (*lead, *kind, fp.W, S), dtype=np.int32)
        out.append(torch.from_numpy(a).cuda())
    return out


def _device_ms(name: str, fn) -> float:
    """One launch's device time: the profiler's over REPS launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if re.search(rf"\bk_{name}\b", e.key)]
    dev = sum(getattr(e, "self_device_time_total", 0) for e in hits)
    if dev <= 0:
        raise RuntimeError(f"the profiler holds no device time for k_{name}")
    return dev / sum(e.count for e in hits) / 1e3


def equal_outputs(got: list, want) -> bool:
    """A launch's outputs (a list) torch.equal to the plain body's, which
    returns a tensor for one output and a tuple for several."""
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


def run(name: str, S: int, counts, out=print, K: int = 1) -> list:
    op = _ops()[name]
    lib = kernels.ENTRIES[op.symbol][0]
    args = operands(name, S, K=K)
    want = op.plain(*args)
    variants = {}
    for nw in counts:
        with warps(name, nw):
            so = kernels.bind(lib, kernels.load(lib, fp.FOLDS_NP, fp.TOPFM_NP, kernels.build()))
            st = coop.kernel_stats(name)
            smem = getattr(so, f"lh_{lib}_launch_smem")(coop.slot(name))
        got = kernels.launch(op.symbol, args, lib=so)
        torch.cuda.synchronize()
        if not equal_outputs(got, want):
            raise AssertionError(f"{name} with {nw} warps != its plain body")
        if smem != st["smem_bytes"]:
            raise AssertionError(f"{name} with {nw} warps launches {smem} B, lays out "
                                 f"{st['smem_bytes']} B")
        variants[nw] = dict(so=so, stats=st, ms=[])
    order = list(counts)
    for turn in range(4):  # a b b a a b b a
        for nw in (order if turn % 2 == 0 else order[::-1]):
            v = variants[nw]
            v["ms"].append(_device_ms(name, lambda: kernels.launch(op.symbol, args, lib=v["so"])))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    rows = []
    for nw, v in variants.items():
        st = v["stats"]
        rows.append(dict(kernel=name, warps=nw, K=K, S=S, device_ms=float(np.median(v["ms"])),
                         device_ms_turns=v["ms"], rounds=st["rounds"],
                         smem_bytes=st["smem_bytes"], equal_to_plain_body=True, card=card))
        out(json.dumps(rows[-1]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", choices=sorted(_ops()))
    ap.add_argument("--S", type=int, nargs="+", default=[1024], help="lanes (default 1024)")
    ap.add_argument("--K", type=int, nargs="+", default=[1], help="stack depths (default 1)")
    ap.add_argument("--warps", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("coop_warps: torch sees no CUDA device", file=sys.stderr)
        return 2
    for K in a.K:
        for S in a.S:
            run(a.name, S, a.warps, K=K)
    return 0


if __name__ == "__main__":
    sys.exit(main())
