"""The fused Fp-product microbenchmark on the GPU: the port of the
reference's tools/ubench_pallas.py.

Two hand-written CUDA kernels (csrc/ubench_mul.cu) over the round-2 product
in the [36, S] layout, with a 3-pass carry normalization at every site:
`mul` normalizes both operands and takes one product per launch;
`mul_chain` normalizes both and takes R chained products x <- x b in one
launch, R a kernel argument. Both run one body, a thread an element, the
tables read from the block's copy in shared memory. Beside them, the lane
baseline: the Fp core's `norm3` on both operands, then R launches of the
lane `mul` (ops/lane/fp.py). The chain against the baseline says what R products in
one launch save against R launches.

Run on a machine with a CUDA card (the kernels build at first use):

    python -m lighthouse_tpu_torch.tools.ubench_mul [S] [R] [--device cpu]

S lanes (default 110,592) and R chained products (default 40), as the
reference's defaults. It prints the correctness of the products on 8 lanes
against Python ints, then ms per launch and ps per element-product of the
single kernel, the chain and the lane baseline. `--device cpu` runs the
plain PyTorch versions (use a small S).

    python -m lighthouse_tpu_torch.tools.ubench_mul --sweep 64:1 128:2 --S 4096 110592

times the kernels' launch shape instead: csrc/ubench_mul.cu built once a
THREADS:MIN_BLOCKS pair (threads a block and the launch bound's minimum
blocks an SM, UB_THREADS and UB_MIN_BLOCKS, the same for both kernels),
all builds in parallel, each kernel held torch.equal to its plain body at
each S, then timed in turns (a b b a, the profiler's device ms), one JSON
line a kernel, pair and S with its ptxas line and the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import random
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..crypto.bls.params import P
from ..ops import fp as _base
from ..ops.lane import fp, kernels

W = _base.W                # 36
B = _base.B                # 11
MASK = _base.MASK
CONVW = _base.CONVW        # 73
FOLD_AT = _base.FOLD_AT    # 35

S_DEFAULT = 110592
R_DEFAULT = 40

# The microbenchmark's own tables, rebuilt from the round-2 constants:
#   FOLDS [W, 41] = [FOLD_FULL.T | FOLD_2.T | FOLD_1.T]
#   TOPFM [3, CONVW] = topfold vectors for widths 73, 37, 36 (zero-padded)
# C order: the library copies them by pointer.
FOLDS = np.ascontiguousarray(
    np.concatenate([_base.FOLD_FULL.T, _base.FOLD_2.T, _base.FOLD_1.T], axis=1),
    dtype=np.int32,
)
TOPFM = np.zeros((3, CONVW), np.int32)
TOPFM[0, :] = _base._topfold(CONVW)
TOPFM[1, :37] = _base._topfold(37)
TOPFM[2, :W] = _base._topfold(W)
_TROW = {CONVW: 0, 37: 1, W: 2}

_DEVICE_CONSTS: dict = {}


def consts(device) -> tuple:
    """(folds, topf) as tensors on `device` (made once per device)."""
    device = torch.device(device)
    c = _DEVICE_CONSTS.get(device)
    if c is None:
        c = _DEVICE_CONSTS[device] = (
            torch.from_numpy(FOLDS).to(device), torch.from_numpy(TOPFM).to(device)
        )
    return c


# ---------------------------------------------------------------- plain body
# The reference's jnp bodies over [..., W|CONVW, S], operation for operation.


def _norm1(x, topf):
    """One carry pass along the limb axis; top carry folded mod p."""
    w = x.shape[-2]
    lo = x & MASK
    hi = x >> B
    out = lo + F.pad(hi[..., :-1, :], (0, 0, 1, 0))
    return out + hi[..., -1:, :] * topf[_TROW[w], :w, None]


def _norm3(x, topf):
    return _norm1(_norm1(_norm1(x, topf), topf), topf)


def _fold(x, mt):
    """x [..., n, S] -> [..., W, S] through the fold matrix mt [W, n - 35]."""
    nhi = x.shape[-2] - FOLD_AT
    acc = F.pad(x[..., :FOLD_AT, :], (0, 0, 0, W - FOLD_AT))
    for k in range(nhi):
        acc = acc + mt[:, k, None] * x[..., FOLD_AT + k, None, :]
    return acc


def _mul_body(a, b, folds, topf):
    """The fused product of normalized-limb operands a, b [..., W, S]."""
    acc = torch.zeros((*a.shape[:-2], CONVW, a.shape[-1]), dtype=torch.int32,
                      device=a.device)
    for i in range(W):
        acc = acc + F.pad(a[..., i, None, :] * b, (0, 0, i, CONVW - W - i))
    wide = _norm3(acc, topf)
    x = _norm3(F.pad(_fold(wide, folds[:, :38]), (0, 0, 0, 1)), topf)
    x = _norm3(_fold(x, folds[:, 38:40]), topf)
    return _norm3(_fold(x, folds[:, 40:41]), topf)


def _chain_body(a, b, rounds: int, folds, topf):
    """`_kernel_chain` (`_kernel` at rounds = 1): both operands normed,
    then `rounds` products x <- x b."""
    x = _norm3(a, topf)
    b = _norm3(b, topf)
    for _ in range(rounds):
        x = _mul_body(x, b, folds, topf)
    return x


# ---------------------------------------------------------------- kernels

_LOCK = threading.Lock()
_LIB = None


def _bind(out=None):
    """The ubench_mul library built in `out` (default: with the others,
    kernels.build), its own tables copied in, its two entries bound (R an
    int argument)."""
    so = kernels.load("ubench_mul", FOLDS, TOPFM, out)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    so.lh_ubench_mul.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
    so.lh_ubench_mul_chain.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    so.lh_ubench_mul.restype = so.lh_ubench_mul_chain.restype = i32
    return so


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind()
    return _LIB


class UbenchKernel:
    """One of the two kernels and its plain version. `mul(a, b)` and
    `mul_chain(a, b, R)` take [..., W, S] int32 operands of one shape; on
    CPU tensors they run the plain body, on CUDA tensors they launch the
    kernel (counted in fp.LAUNCHES under `name`) or raise."""

    def __init__(self, name: str, symbol: str, chained: bool):
        self.name = name
        self.symbol = symbol
        self.chained = chained

    def _rounds(self, rounds) -> int:
        if len(rounds) != int(self.chained):
            raise TypeError(f"{self.name} takes (a, b{', R' if self.chained else ''})")
        return int(rounds[0]) if self.chained else 1

    def plain(self, a, b, *rounds):
        if a.device.type == "cuda":
            fp.PLAIN_CUDA_CALLS[self.name] += 1
        return _chain_body(a, b, self._rounds(rounds), *consts(a.device))

    def __call__(self, a, b, *rounds):
        n = self._rounds(rounds)
        if a.device != b.device:
            raise ValueError(f"{self.name}: operands on {a.device} and {b.device}")
        if a.device.type == "cpu":
            return self.plain(a, b, *rounds)
        if a.device.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for device {a.device}")
        if a.shape != b.shape or a.dim() < 2 or a.shape[-2] != W:
            raise ValueError(f"{self.name}: operands {tuple(a.shape)}, {tuple(b.shape)} "
                             f"are not one [..., {W}, S] shape")
        if a.dtype != torch.int32 or b.dtype != torch.int32:
            raise TypeError(f"{self.name}: operands must be int32")
        if n < 0:
            raise ValueError(f"{self.name}: R = {n} < 0")
        a, b = a.contiguous(), b.contiguous()
        S = a.shape[-1]
        K = a.numel() // (W * S) if S else 0
        if K * S == 0:
            raise ValueError(f"{self.name}: empty batch")
        out = _launch(_lib(), self.symbol, a, b, (n,) if self.chained else (), K, S)
        fp.LAUNCHES[self.name] += 1
        return out


def _launch(lib, symbol: str, a, b, rounds: tuple, K: int, S: int):
    """C entry `symbol` of `lib` on contiguous [K, W, S] operands, on the
    current stream; a fresh output, or raise."""
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = getattr(lib, symbol)(a.data_ptr(), b.data_ptr(), out.data_ptr(), *rounds, K, S,
                                  stream)
    if rc:
        msg = lib.lh_ubench_mul_error_string(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc}: {msg}")
    return out


mul = UbenchKernel("ubench_mul", "lh_ubench_mul", chained=False)
mul_chain = UbenchKernel("ubench_mul_chain", "lh_ubench_mul_chain", chained=True)


def lane_chain(a, b, rounds: int):
    """The lane baseline: the Fp core's `norm3` on both operands, then
    `rounds` launches of the lane `mul` (x <- x b)."""
    x = fp.norm3(a)
    b = fp.norm3(b)
    for _ in range(rounds):
        x = fp.mul(x, b)
    return x


# ---------------------------------------------------------------- entry point


def operands(S: int, device):
    """The reference's operands: 8 seeded canonical elements per side
    (random.seed(2)), tiled over S lanes. Returns (ints_a, ints_b, A, B)."""
    rnd = random.Random(2)
    ints_a = [rnd.randrange(P) for _ in range(8)]
    ints_b = [rnd.randrange(P) for _ in range(8)]
    tile = (S + 7) // 8
    A = np.tile(fp.pack(ints_a), (1, tile))[:, :S]
    Bm = np.tile(fp.pack(ints_b), (1, tile))[:, :S]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return ints_a, ints_b, t(A), t(Bm)


def _best_ms(fn, device, reps: int = 3) -> float:
    """The best of `reps` calls after one warm call: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            best = min(best, s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def run(S: int = S_DEFAULT, R: int = R_DEFAULT, device=None, out=print) -> dict:
    """The reference's `__main__` on the port, returning what it prints:
    correctness of the single product and of the chain on 8 lanes against
    Python ints, and the best ms of the single kernel, the chain and the
    lane baseline, with ps per element-product."""
    dev = fp.resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out(f"device={name}, S={S}, R={R}")
    ints_a, ints_b, A, Bm = operands(S, dev)

    t0 = time.perf_counter()
    single = fp.unpack(mul(A, Bm)[:, :8])
    kind = "cuda" if dev.type == "cuda" else "plain"
    out(f"single-mul {kind} build+run: {time.perf_counter() - t0:.1f}s")
    ok_single = single == [a * b % P for a, b in zip(ints_a, ints_b)]
    chain = fp.unpack(mul_chain(A, Bm, R)[:, :8])
    ok_chain = chain == [a * pow(b, R, P) % P for a, b in zip(ints_a, ints_b)]
    lane = fp.unpack(lane_chain(A, Bm, R)[:, :8])
    ok_lane = lane == chain
    out(f"correctness: single {'PASS' if ok_single else 'FAIL'}, "
        f"chain {'PASS' if ok_chain else 'FAIL'}, lane {'PASS' if ok_lane else 'FAIL'}")

    res = dict(S=S, R=R, device=name, ok=ok_single and ok_chain and ok_lane)
    res["single_ms"] = t = _best_ms(lambda: mul(A, Bm), dev)
    out(f"{kind} single mul:       {t:8.3f} ms  ({t * 1e9 / S:7.1f} ps/elem-mul)")
    res["chain_ms"] = t = _best_ms(lambda: mul_chain(A, Bm, R), dev)
    out(f"{kind} {R}-mul chain:     {t:8.3f} ms  ({t / R:6.3f} ms/mul, "
        f"{t * 1e9 / R / S:7.1f} ps/elem-mul)")
    res["lane_ms"] = t = _best_ms(lambda: lane_chain(A, Bm, R), dev)
    out(f"lane mul x {R} launches: {t:8.3f} ms  ({t / R:6.3f} ms/mul, "
        f"{t * 1e9 / R / S:7.1f} ps/elem-mul)")
    return res


# ---------------------------------------------------------------- sweep


def build_variants(shapes) -> dict:
    """csrc/ubench_mul.cu built once a (threads, min_blocks) pair, with
    UB_THREADS and UB_MIN_BLOCKS set (both kernels' launch shape), each in
    a directory of its own beside the kernels' build, all nvcc runs
    started together; returns pair -> (directory, ptxas log)."""
    base = kernels.build_dir()
    jobs = {}
    for t, m in shapes:
        out = base / f"ubench_{t}x{m}"
        out.mkdir(parents=True, exist_ok=True)
        so = out / "libubench_mul.so"
        if so.exists():
            jobs[t, m] = (None, out)
            continue
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, f"-DUB_THREADS={t}",
               f"-DUB_MIN_BLOCKS={m}", "-o", str(so), str(kernels.CSRC / "ubench_mul.cu")]
        jobs[t, m] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), out)
    built = {}
    for pair, (proc, out) in jobs.items():
        if proc is not None:
            log, _ = proc.communicate()
            (out / "ubench_mul.log").write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(f"ubench_mul.cu at {pair}: nvcc failed:\n{log}")
        built[pair] = (out, (out / "ubench_mul.log").read_text())
    return built


def kernel_ptxas(log: str) -> dict:
    """Each kernel's lines of a ptxas -v log, by its counter's name: its
    stack frame and spills, its registers and shared memory."""
    lines = log.splitlines()
    return {(mul_chain if "k_ubench_mul_chain" in line else mul).name:
            [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3]]
            for i, line in enumerate(lines)
            if "Function properties for" in line and "k_ubench_mul" in line}


def sweep(shapes, widths, R: int = R_DEFAULT, out=print) -> list:
    """Both kernels (the chain at R) at each (threads, min_blocks) of
    `shapes` and each S of `widths`: held torch.equal to the plain body,
    then the profiler's device ms of a launch in 4 turns a b b a."""
    from .fp_ms import launch_turns
    from .ladder_ms import card

    built = build_variants(shapes)
    libs = {pair: _bind(d) for pair, (d, _) in built.items()}
    rows = []
    for S in widths:
        _, _, A, Bm = operands(S, "cuda")
        for op, rounds in ((mul, ()), (mul_chain, (R,))):
            want = op.plain(A, Bm, *rounds)
            for pair, lib in libs.items():
                if not torch.equal(_launch(lib, op.symbol, A, Bm, rounds, 1, S), want):
                    raise AssertionError(f"{op.name} at {pair}, S={S}: kernel != plain body")
            turns = {pair: [] for pair in libs}
            order = list(libs)
            for turn in range(4):
                for pair in (order if turn % 2 == 0 else order[::-1]):
                    turns[pair] += launch_turns(
                        rf"\bk_{op.name}\b",
                        lambda: _launch(libs[pair], op.symbol, A, Bm, rounds, 1, S), traces=1)
            for (t, m), ms in turns.items():
                rows.append(dict(tool="ubench_mul --sweep", kernel=op.name, threads=t,
                                 min_blocks=m, S=S, **({"R": R} if rounds else {}),
                                 device_ms=float(np.median(ms)), device_ms_turns=ms,
                                 ptxas=kernel_ptxas(built[t, m][1])[op.name],
                                 equal_to_plain_body=True, card=card()))
                out(json.dumps(rows[-1]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("S", type=int, nargs="?", default=S_DEFAULT, help="lanes")
    ap.add_argument("R", type=int, nargs="?", default=R_DEFAULT, help="chained products")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--sweep", nargs="+", metavar="THREADS:MIN_BLOCKS",
                    help="time the kernels' launch shapes instead")
    ap.add_argument("--S", dest="widths", type=int, nargs="+", default=[4096, S_DEFAULT],
                    help="the sweep's lanes")
    args = ap.parse_args(argv)
    if args.sweep:
        if not torch.cuda.is_available():
            print("ubench_mul: torch sees no CUDA device", file=sys.stderr)
            return 2
        shapes = [tuple(int(v) for v in p.split(":")) for p in args.sweep]
        sweep(shapes, args.widths, args.R)
        return 0
    return 0 if run(args.S, args.R, args.device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
