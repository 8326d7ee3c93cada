"""Kernel launches and torch ops of one BLS verify, counted on the CPU.

Runs `verify_core` over S zero lanes with every kernel (`fp.KernelOp`)
replaced by a stand-in that returns zeros of the kernel's output shapes
(the path's control flow does not depend on the values), under a
`TorchDispatchMode` that counts the torch ops the path dispatches around
the kernels (the stand-ins' own zeros are not counted). Per kernel it also
counts the widths it is launched at: (K, S), K the lane elements' stack
(the product of the operand's leading dims) and S the lanes.

    python -m lighthouse_tpu_torch.tools.verify_census 128 1024

prints one JSON line per bucket: launches by kernel and in all, torch ops,
and each kernel's launches by width ("KxS").
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..crypto.bls.backends import cuda as CB
from ..ops.lane import fp, kernels


class _CountOps(TorchDispatchMode):
    """Counts the aten ops dispatched while it is active and not paused."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops += 1
        return func(*args, **(kwargs or {}))


def census(S: int) -> dict:
    """Launches, launches by width and torch ops of one `verify_core` over
    S lanes on the CPU, the kernels replaced by shape-only stand-ins."""
    launches, widths = Counter(), {}
    mode = _CountOps()

    def stand_in(op, *arrays):
        launches[op.name] += 1
        _, ins, outs = kernels.ENTRIES[op.symbol]
        leads = [a.shape[: a.dim() - len(kernels._elem(k)) - 1] for a, k in zip(arrays, ins)]
        lead = torch.broadcast_shapes(*leads)
        lanes = max(a.shape[-1] for a in arrays)
        widths.setdefault(op.name, Counter())[f"{int(np.prod(lead, dtype=np.int64))}x{lanes}"] += 1
        mode.paused = True
        try:
            res = [torch.zeros((*lead, *c, fp.W, lanes), dtype=torch.int32) for c in outs]
        finally:
            mode.paused = False
        return res[0] if len(res) == 1 else tuple(res)

    args = (
        torch.zeros(fp.W, S, dtype=torch.int32), torch.zeros(fp.W, S, dtype=torch.int32),
        *(torch.zeros(2, fp.W, S, dtype=torch.int32) for _ in range(4)),
        torch.zeros(64, S, dtype=torch.int32), torch.zeros(S, dtype=torch.bool),
    )
    call = fp.KernelOp.__call__
    fp.KernelOp.__call__ = stand_in
    try:
        with mode:
            CB.verify_core(*args)
    finally:
        fp.KernelOp.__call__ = call
    return dict(launches=launches, torch_ops=mode.ops, widths=widths)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("buckets", type=int, nargs="*", default=[128, 1024])
    a = ap.parse_args(argv)
    for S in a.buckets:
        c = census(S)
        print(json.dumps(dict(
            bucket=S, launches=sum(c["launches"].values()), torch_ops=c["torch_ops"],
            by_kernel=dict(sorted(c["launches"].items())),
            widths={k: dict(sorted(v.items())) for k, v in sorted(c["widths"].items())},
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
