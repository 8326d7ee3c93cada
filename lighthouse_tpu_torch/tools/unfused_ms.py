"""Device time of the standalone Fp12 square and line product, and of the
unfused Miller doubling that runs them.

Two measurements, one JSON line each, with the card's `nvidia-smi` name
and power limit; device ms from the profiler, each device event once
(tools/ladder_ms.py's `launch_ms` and `device_ms`):

- `f12sqr` and `f12mul_034`, one launch, at each width (--S), on seeded
  operands (standard limbs): the median of 4 traces of REPS launches,
  after the outputs are held torch.equal to the plain body.
- the Miller doubling at one width (--doubling-S): NDBL chained
  `miller_dbl_iter` launches from seeded operands, then the same NDBL
  doublings unfused, f12mul_034(f12sqr(f), c0, c1, c4) with the line
  coefficients from the plain doubling-step body, each iteration's f
  torch.equal to the fused kernel's; then the device ms of one run of
  each and of each of its kernels.

Run on a machine with a CUDA card:

    python -m lighthouse_tpu_torch.tools.unfused_ms --S 1 128 1024 4096 --doubling-S 128

It calls only the package's entry points, so a copy of it in another
tree of the package (its tools/, beside ladder_ms.py) times that tree the
same way.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from ..ops.lane import fp, pairing, tower
from .ladder_ms import card, device_ms, launch_ms

NDBL = 63  # the doubling iterations of a Miller loop over |u|
# component shapes of each kernel's operands
FIELDS = {"f12sqr": [(2, 3, 2)], "f12mul_034": [(2, 3, 2), (2,), (2,), (2,)]}


def operands(fields, S: int, seed: int = 17, device: str = "cuda") -> list:
    """Seeded standard-limb operands of the given component shapes on S lanes."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 1 << fp.B, (*c, fp.W, S), dtype=np.int32)).to(device)
            for c in fields]


def launches(widths, out=print) -> list:
    rows = []
    for name, fields in FIELDS.items():
        op = getattr(tower, name)
        for S in widths:
            args = operands(fields, S)
            if not torch.equal(op(*args), op.plain(*args)):
                raise AssertionError(f"{name} S={S}: kernel != plain body")
            turns = [launch_ms(name, lambda: op(*args)) for _ in range(4)]
            rows.append(dict(tool="unfused_ms", kernel=name, S=S,
                             device_ms=statistics.median(turns), device_ms_turns=turns,
                             equal_to_plain_body=True, card=card()))
            out(json.dumps(rows[-1]))
    return rows


def doubling_runs(S: int, device: str = "cuda") -> tuple:
    """(the fused doublings, the unfused ones) on S lanes: NDBL chained
    miller_dbl_iter launches from seeded operands (f, XT, YT, ZT, xP, yP),
    after checking that each unfused iteration gives the fused f."""
    f, *t, xp, yp = operands([(2, 3, 2), (2,), (2,), (2,), (), ()], S, seed=18, device=device)
    calls = []
    for _ in range(NDBL):
        res = pairing._dbl_iter(f, *t, xp, yp)
        calls.append(((f, *t, xp, yp), res[0]))
        f, t = res[0], list(res[1:])
    c = fp.consts(device)
    lines = [pairing._dbl_step_body(c["folds"], c["topf"], *args[1:])[3:] for args, _ in calls]

    def fused():
        return [pairing._dbl_iter(*args) for args, _ in calls]

    def unfused():
        return [tower.f12mul_034(tower.f12sqr(args[0]), *ln)
                for (args, _), ln in zip(calls, lines, strict=True)]

    if not all(torch.equal(g, want) for g, (_, want) in zip(unfused(), calls, strict=True)):
        raise AssertionError("an unfused doubling != miller_dbl_iter's f")
    return fused, unfused


def doubling(S: int, out=print) -> dict:
    fused, unfused = doubling_runs(S)
    fu, un = device_ms(fused), device_ms(unfused)
    row = dict(tool="unfused_ms", path="miller_doubling", S=S, iterations=NDBL,
               unfused_device_ms=un["device_ms"], unfused_kernels_ms=un["kernels_ms"],
               fused_device_ms=fu["device_ms"], fused_kernels_ms=fu["kernels_ms"],
               agree=True, card=card())
    out(json.dumps(row))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--S", type=int, nargs="+", default=[128, 4096],
                    help="widths of the single-launch timings (default 128 4096)")
    ap.add_argument("--doubling-S", type=int, default=128,
                    help="width of the doublings (default 128, phase 7's Miller loop)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("unfused_ms: torch sees no CUDA device", file=sys.stderr)
        return 2
    launches(a.S)
    doubling(a.doubling_S)
    return 0


if __name__ == "__main__":
    sys.exit(main())
