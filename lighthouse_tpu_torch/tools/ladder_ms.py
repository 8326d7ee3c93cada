"""Device time of the per-lane ladder steps, and of the ladders that run them.

Two measurements, one JSON line each, with the card's `nvidia-smi` name
and power limit; device ms from the profiler, each device event once:

- `ladder_step_f1` and `ladder_step_f2`, one launch, at each width (--S),
  on seeded operands (standard limbs, no point at infinity) with the bit
  row mixed (seeded 0 or 1) and with every bit set: the median of 4
  traces of REPS launches, after the outputs are held torch.equal to the
  plain body.
- the ladders of chip_smoke.py's phase 7 at one width (--ladder-S):
  `scalar_mul` over G1 (64 ladder steps) and `scalar_mul_with_static`
  over G2 with the static |u| (64 ladder steps, 6 adds), on the
  generators, one a lane, with seeded 64-bit scalars, each beside the
  windowed chain that the verify path runs on the same lanes
  (`chains.scalar_mul_w2`; over G2 with `scalar_mul_static`). The results
  agree on every lane (`jac_eq`; the static accumulator torch.equal);
  then the device ms of one run of each and of each of its kernels.

Run on a machine with a CUDA card:

    python -m lighthouse_tpu_torch.tools.ladder_ms --S 1024 4096 --ladder-S 1024

It calls only the package's entry points, so a copy of it in another
tree of the package (its tools/) times that tree the same way.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..crypto.bls import curve as C, params
from ..ops.lane import chains, fp, jacobian as J

REPS = 20
NBITS = 64


def _device_time(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def _trace(fn):
    """The device-side entries of the profiler's trace of fn()."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn) -> dict:
    """Device ms of one call of fn (after one call untraced), each device
    event once, and each of the package's k_* kernels' share."""
    fn()
    dev = _trace(fn)
    ours = {}
    for e in dev:
        if (m := re.search(r"\bk_\w+", e.key)):
            ours[m.group()] = ours.get(m.group(), 0.0) + _device_time(e) / 1e3
    return dict(device_ms=sum(map(_device_time, dev)) / 1e3, kernels_ms=ours)


def launch_ms(name: str, fn) -> float:
    """One launch's device ms: kernel k_<name>'s over REPS launches."""
    fn()

    def reps():
        for _ in range(REPS):
            fn()

    hits = [e for e in _trace(reps) if re.search(rf"\bk_{name}\b", e.key)]
    if not hits or sum(map(_device_time, hits)) <= 0:
        raise RuntimeError(f"the profiler holds no device time for k_{name}")
    return sum(map(_device_time, hits)) / sum(e.count for e in hits) / 1e3


def step_operands(nc: int, S: int, bits: str, seed: int = 16) -> list:
    """Seeded operands of a ladder step on S lanes: accumulator and addend
    (standard limbs), then the bit row, seeded 0 / 1 or all 1."""
    rng = np.random.default_rng(seed)
    comp = (2,) if nc == 2 else ()
    pts = [rng.integers(0, 1 << fp.B, (*comp, fp.W, S), dtype=np.int32) for _ in range(6)]
    bit = (rng.integers(0, 2, (1, S), dtype=np.int32) if bits == "mixed"
           else np.ones((1, S), np.int32))
    return [torch.from_numpy(a).cuda() for a in (*pts, bit)]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def steps(widths, out=print) -> list:
    rows = []
    for name, nc in (("ladder_step_f1", 1), ("ladder_step_f2", 2)):
        op = getattr(J, f"_{name}")
        for S in widths:
            for bits in ("mixed", "ones"):
                args = step_operands(nc, S, bits)
                got, want = op(*args), op.plain(*args)
                if not all(torch.equal(g, w) for g, w in zip(got, want, strict=True)):
                    raise AssertionError(f"{name} S={S} bits={bits}: kernel != plain body")
                turns = [launch_ms(name, lambda: op(*args)) for _ in range(4)]
                rows.append(dict(tool="ladder_ms", kernel=name, S=S, bits=bits,
                                 set_share=float(args[-1].double().mean()),
                                 device_ms=statistics.median(turns), device_ms_turns=turns,
                                 equal_to_plain_body=True, card=card()))
                out(json.dumps(rows[-1]))
    return rows


def ladder_runs(S: int, device: str = "cuda") -> dict:
    """path -> (the per-lane ladder, its windowed counterpart) on S lanes,
    after checking that their results agree on every lane."""
    rng = np.random.default_rng(1024)
    scalars = [int.from_bytes(rng.bytes(8), "big") | 1 for _ in range(S)]
    bits = torch.tensor([[(k >> i) & 1 for k in scalars] for i in range(NBITS)],
                        dtype=torch.int32, device=device)
    g1 = J.pack_g1([C.G1_GEN] * S, device)
    g2 = J.pack_g2([C.G2_GEN] * S, device)
    m_abs = -params.X
    dyn, stat = J.scalar_mul_with_static(J.FP2, g2, bits, m_abs)
    ok = (bool(J.jac_eq(J.FP1, J.scalar_mul(J.FP1, g1, bits),
                        chains.scalar_mul_w2(J.FP1, g1, bits)).all())
          and bool(J.jac_eq(J.FP2, dyn, chains.scalar_mul_w2(J.FP2, g2, bits)).all())
          and all(torch.equal(a, b)
                  for a, b in zip(stat, J.scalar_mul_static(J.FP2, g2, m_abs), strict=True)))
    if not ok:
        raise AssertionError("a per-lane ladder disagrees with its windowed chain")
    return {
        "g1": (lambda: J.scalar_mul(J.FP1, g1, bits),
               lambda: chains.scalar_mul_w2(J.FP1, g1, bits)),
        "g2_with_static": (lambda: J.scalar_mul_with_static(J.FP2, g2, bits, m_abs),
                           lambda: (chains.scalar_mul_w2(J.FP2, g2, bits),
                                    J.scalar_mul_static(J.FP2, g2, m_abs))),
    }


def ladders(S: int, out=print) -> list:
    rows = []
    for path, (ladder, windowed) in ladder_runs(S).items():
        lad, win = device_ms(ladder), device_ms(windowed)
        rows.append(dict(tool="ladder_ms", path=path, S=S, nbits=NBITS,
                         ladder_device_ms=lad["device_ms"], ladder_kernels_ms=lad["kernels_ms"],
                         windowed_device_ms=win["device_ms"],
                         windowed_kernels_ms=win["kernels_ms"], agree=True, card=card()))
        out(json.dumps(rows[-1]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--S", type=int, nargs="+", default=[1024, 4096],
                    help="widths of the single-step timings (default 1024 4096)")
    ap.add_argument("--ladder-S", type=int, default=1024,
                    help="width of the ladders (default 1024, the gossip bucket)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ladder_ms: torch sees no CUDA device", file=sys.stderr)
        return 2
    steps(a.S)
    ladders(a.ladder_S)
    return 0


if __name__ == "__main__":
    sys.exit(main())
