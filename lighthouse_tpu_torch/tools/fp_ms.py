"""Device time of `canonical`, `reduce_light` and `sqr` a launch, at the
widths a BLS verify runs them; of the microbenchmark's single product
`ubench_mul` and chained product `ubench_mul_chain` (R = 40), and of the
lane baseline's `norm3`, at 4,096 lanes and the microbenchmark's 110,592;
and of `canon_reduce`, which no path launches, at 1 and 4,096 lanes.

One JSON line a kernel and width, with the card's `nvidia-smi` name and
power limit; device ms from the profiler (the median of 4 traces of 20
launches, tools/ladder_ms.py's trace), after the kernel's output, through
its entry point (OPS), is held torch.equal to the plain body on the same
seeded operands (the microbenchmark's kernels', its 8 tiled elements);
`norm3`'s also cold (`cold_device_ms`: the L2 cleared by a write of 256
MiB before each launch, outside the kernel's own device time).
Run on a machine with a CUDA card:

    python -m lighthouse_tpu_torch.tools.fp_ms [kernel ...]

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
from . import ubench_mul as U
from .ladder_ms import REPS, _device_time, _trace, card

# the widths a bucket-1024 verify runs each at, as (K, S) stacks, the
# recorded pairing layout of 6 x 4,096 lane elements for reduce_light,
# sqr's one launch a verify at buckets 128 and 1024 (and one lane, and
# 4,096); the microbenchmark's kernels and norm3 at 4,096 lanes and the
# microbenchmark's 110,592 (norm3 also at one lane: a launch's floor);
# canon_reduce at one lane and 4,096
WIDTHS = {
    "canonical": [(1, 1), (2, 1), (2, 1024), (8, 2048)],
    "reduce_light": [(2, 2048), (6, 1), (1, 4097), (6, 4096)],
    "sqr": [(1, 1), (1, 128), (1, 1024), (1, 4096)],
    "ubench_mul_chain": [(1, 4096), (1, U.S_DEFAULT)],
    "ubench_mul": [(1, 4096), (1, U.S_DEFAULT)],
    "norm3": [(1, 1), (1, 4096), (1, U.S_DEFAULT)],
    "canon_reduce": [(1, 1), (1, 4096)],
}
CHAIN_R = U.R_DEFAULT
# kernels bound by their bytes whose input the 50 MB L2 holds between
# launches: also timed cold, a write of L2_FLUSH_BYTES before each launch
COLD = ("norm3",)
L2_FLUSH_BYTES = 256 << 20


def operands(name: str, K: int, S: int, seed: int = 19) -> list:
    """Seeded operands [K, W, S]: canonical's and canon_reduce's a
    difference of two standard elements (eq_zero's), reduce_light's, sqr's
    and norm3's a sum of three, signs mixed; the microbenchmark's kernels'
    its own (and the chain's R)."""
    if name.startswith("ubench"):
        _, _, a, b = U.operands(S, "cuda")
        return [a, b] + ([CHAIN_R] if name == "ubench_mul_chain" else [])
    rng = np.random.default_rng(seed)

    def std():
        return rng.integers(0, 1 << fp.B, (K, fp.W, S), dtype=np.int32)

    a = std() - std() if name in ("canonical", "canon_reduce") else std() + std() - std()
    return [torch.from_numpy(a).cuda()]


def launch_turns(pattern: str, fn, traces: int = 4) -> list:
    """One launch's device ms in each of `traces` traces of REPS launches:
    the kernel whose trace name matches `pattern`."""
    fn()
    turns = []
    for _ in range(traces):
        def reps():
            for _ in range(REPS):
                fn()

        hits = [e for e in _trace(reps) if re.search(pattern, e.key)]
        total = sum(map(_device_time, hits))
        if not hits or total <= 0:
            raise RuntimeError(f"the profiler holds no device time for {pattern}")
        turns.append(total / sum(e.count for e in hits) / 1e3)
    return turns


OPS = {"canonical": fp.canonical_op, "reduce_light": fp.reduce_light, "sqr": fp.sqr,
       "ubench_mul_chain": U.mul_chain, "ubench_mul": U.mul, "norm3": fp.norm3,
       "canon_reduce": fp.canon_reduce}


def library(names=tuple(OPS), out=print) -> list:
    rows = []
    for name in names:
        op = OPS[name]
        for K, S in WIDTHS[name]:
            args = operands(name, K, S)
            if not torch.equal(op(*args), op.plain(*args)):
                raise AssertionError(f"{name} {K}x{S}: kernel != plain body")
            turns = launch_turns(rf"\bk_{name}\b", lambda: op(*args))
            rows.append(dict(tool="fp_ms", kernel=name, K=K, S=S,
                             **({"R": CHAIN_R} if name == "ubench_mul_chain" else {}),
                             device_ms=statistics.median(turns), device_ms_turns=turns,
                             equal_to_plain_body=True, card=card()))
            if name in COLD:
                flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
                cold = launch_turns(rf"\bk_{name}\b", lambda: (flush.fill_(0), op(*args)))
                rows[-1].update(cold_device_ms=statistics.median(cold), cold_device_ms_turns=cold)
            out(json.dumps(rows[-1]))
    return rows


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or list(OPS)
    if not set(names) <= set(OPS):
        print(f"fp_ms: kernels are {', '.join(OPS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("fp_ms: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    library(names, lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
