"""Device time of `canonical` and `reduce_light` a launch, at the widths a
BLS verify runs them.

One JSON line a kernel and width, with the card's `nvidia-smi` name and
power limit; device ms from the profiler (the median of 4 traces of 20
launches, tools/ladder_ms.py's trace), after the kernel's output, through
`fp.canonical_op` and `fp.reduce_light`, is held torch.equal to the plain
body on the same seeded operands. Run on a machine with a CUDA card:

    python -m lighthouse_tpu_torch.tools.fp_ms

It calls only the package's entry points, so a copy of it in another tree
of the package (its tools/, beside ladder_ms.py) times that tree's kernels
the same way.
"""

from __future__ import annotations

import json
import re
import statistics
import sys

import numpy as np
import torch

from ..ops.lane import fp
from .ladder_ms import REPS, _device_time, _trace, card

# the widths a bucket-1024 verify runs each at, as (K, S) stacks, and the
# recorded pairing layout of 6 x 4,096 lane elements for reduce_light
WIDTHS = {
    "canonical": [(1, 1), (2, 1), (2, 1024), (8, 2048)],
    "reduce_light": [(2, 2048), (6, 1), (1, 4097), (6, 4096)],
}


def operands(name: str, K: int, S: int, seed: int = 19) -> torch.Tensor:
    """Seeded operands [K, W, S]: canonical's a difference of two standard
    elements (eq_zero's), reduce_light's a sum of three, signs mixed."""
    rng = np.random.default_rng(seed)

    def std():
        return rng.integers(0, 1 << fp.B, (K, fp.W, S), dtype=np.int32)

    a = std() - std() if name == "canonical" else std() + std() - std()
    return torch.from_numpy(a).cuda()


def launch_turns(pattern: str, fn) -> list:
    """One launch's device ms in each of 4 traces of REPS launches: the
    kernel whose trace name matches `pattern`."""
    fn()
    turns = []
    for _ in range(4):
        def reps():
            for _ in range(REPS):
                fn()

        hits = [e for e in _trace(reps) if re.search(pattern, e.key)]
        total = sum(map(_device_time, hits))
        if not hits or total <= 0:
            raise RuntimeError(f"the profiler holds no device time for {pattern}")
        turns.append(total / sum(e.count for e in hits) / 1e3)
    return turns


def library(out=print) -> list:
    rows = []
    for name, op in (("canonical", fp.canonical_op), ("reduce_light", fp.reduce_light)):
        for K, S in WIDTHS[name]:
            x = operands(name, K, S)
            if not torch.equal(op(x), op.plain(x)):
                raise AssertionError(f"{name} {K}x{S}: kernel != plain body")
            turns = launch_turns(rf"\bk_{name}\b", lambda: op(x))
            rows.append(dict(tool="fp_ms", kernel=name, K=K, S=S,
                             device_ms=statistics.median(turns), device_ms_turns=turns,
                             equal_to_plain_body=True, card=card()))
            out(json.dumps(rows[-1]))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("fp_ms: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    library(lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
