"""Build, load and launch the hand-written CUDA kernels (csrc/, sm_90a).

Each source in csrc/ becomes one shared library with a plain C interface,
built by its own `nvcc` (all started together), loaded with ctypes. The
build happens at first use, from the package's sources only, into
lighthouse_tpu_torch/build/kernels/<hash of sources and flags>/, which
.gitignore lists; a build already there is reused. Nothing here runs at
import time: CPU-only machines import this module and never call it.

Every C entry takes its operands as [K, *comp, W, S] int32 pointers plus
K, S and the CUDA stream, launches on that stream, and returns
cudaGetLastError(); `launch` raises on a non-zero code. `comp` is the
operand's field: () for Fp, (2,) for Fp2, (3, 2) for Fp6, (2, 3, 2) for
Fp12, so one lane element of an Fp12 operand is 12 x W limbs. An operand
of kind ROW is no field element but one int32 per lane element (the
windowed ladders' digit), [K, 1, S].
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "build" / "kernels"

# library -> source; each library exports lh_<lib>_init / _error_string
SOURCES = {
    "fp_mul": "fp_mul.cu",        # mul, sqr
    "fp_canon": "fp_canon.cu",    # canon_reduce, canonical, norm3
    "jac_dbl": "jac_dbl.cu",      # jac_dbl_f1, jac_dbl_f2
    "jac_add": "jac_add.cu",      # jac_add_f1, jac_add_f2, add_exact_f1
    "tower": "tower.cu",          # reduce_light, f2mul, f2sqr, f6mul, f12mul,
                                  # f12sqr, f12mul_034
    "miller": "miller.cu",        # miller_dbl_iter, miller_add_iter, cyc_sqr
    "chains": "chains.cu",        # g1_win_step, g2_win_step
    "ladder": "ladder.cu",        # ladder_step_f1, ladder_step_f2
    "inv": "inv.cu",              # inv_w4, inv_bin
    "htc": "htc.cu",              # ratio_chain
    # the Fp-mul microbenchmark: built here with the rest, bound and given
    # its own tables by lighthouse_tpu_torch/tools/ubench_mul.py
    "ubench_mul": "ubench_mul.cu",
    # state hashing and the epoch pass: no Fp tables, no init; bound by
    # ops/lane/sha256.py and ops/epoch.py through `library`
    "sha256": "sha256.cu",        # sha256_pairs
    "epoch": "epoch.cu",          # epoch_updates
}
HEADERS = ("fp_lane.cuh", "coop.cuh", "canon.cuh")

# component shape of each field's lane element
FP, FP2, FP6, FP12 = (), (2,), (3, 2), (2, 3, 2)
# one int32 per lane element: [*lead, 1, S]
ROW = "row"

# C entry -> (library, input fields, output fields)
ENTRIES = {
    "lh_fp_mul": ("fp_mul", (FP, FP), (FP,)),
    "lh_fp_sqr": ("fp_mul", (FP,), (FP,)),
    "lh_fp_canon_reduce": ("fp_canon", (FP,), (FP,)),
    "lh_fp_canonical": ("fp_canon", (FP,), (FP,)),
    "lh_fp_norm3": ("fp_canon", (FP,), (FP,)),
    "lh_jac_dbl_f1": ("jac_dbl", (FP,) * 3, (FP,) * 3),
    "lh_jac_add_f1": ("jac_add", (FP,) * 6, (FP,) * 3),
    "lh_jac_dbl_f2": ("jac_dbl", (FP2,) * 3, (FP2,) * 3),
    "lh_jac_add_f2": ("jac_add", (FP2,) * 6, (FP2,) * 3),
    # P1, P2 -> the exact add: the doubling or infinity where H === 0
    "lh_add_exact_f1": ("jac_add", (FP,) * 6, (FP,) * 3),
    # acc, T1, T2, T3 (a point each), digit -> acc
    "lh_g1_win_step": ("chains", (FP,) * 12 + (ROW,), (FP,) * 3),
    "lh_g2_win_step": ("chains", (FP2,) * 12 + (ROW,), (FP2,) * 3),
    # acc, addend (a point each), bit -> acc, doubled addend
    "lh_ladder_step_f1": ("ladder", (FP,) * 6 + (ROW,), (FP,) * 6),
    "lh_ladder_step_f2": ("ladder", (FP2,) * 6 + (ROW,), (FP2,) * 6),
    "lh_fp_reduce_light": ("tower", (FP,), (FP,)),
    "lh_f2mul": ("tower", (FP2, FP2), (FP2,)),
    "lh_f2sqr": ("tower", (FP2,), (FP2,)),
    "lh_f6mul": ("tower", (FP6, FP6), (FP6,)),
    "lh_f12mul": ("tower", (FP12, FP12), (FP12,)),
    "lh_f12sqr": ("tower", (FP12,), (FP12,)),
    # f, c0, c1, c4 -> f (c0 + c1 v + c4 v w)
    "lh_f12mul_034": ("tower", (FP12, FP2, FP2, FP2), (FP12,)),
    # f, XT, YT, ZT, xP, yP -> f, X3, Y3, Z3
    "lh_miller_dbl_iter": ("miller", (FP12, FP2, FP2, FP2, FP, FP),
                           (FP12, FP2, FP2, FP2)),
    # f, XT, YT, ZT, xQ, yQ, xP, yP -> f, X3, Y3, Z3
    "lh_miller_add_iter": ("miller", (FP12, FP2, FP2, FP2, FP2, FP2, FP, FP),
                           (FP12, FP2, FP2, FP2)),
    "lh_cyc_sqr": ("miller", (FP12,), (FP12,)),
    # a -> a^(p-2): the windowed and the binary Fermat chain
    "lh_inv_w4": ("inv", (FP,), (FP,)),
    "lh_inv_bin": ("inv", (FP,), (FP,)),
    # w -> w^((p^2 - 9) / 16): hash-to-G2's ratio chain
    "lh_ratio_chain": ("htc", (FP2,), (FP2,)),
}

# the tables a library's lh_<lib>_init takes after FOLDS and TOPFM, by their
# names in ops/lane/fp.py: canonical()'s offset KP [37] and subtract ladder
# p * 2^k [7, 37], in global memory, for `canonical` (csrc/fp_lane.cuh
# `g_short`, copied into each block's shared memory)
# and for add_exact_f1's zero tests (copied into each block's shared
# memory)
INIT_TABLES = {"fp_canon": ("KP_37", "PK_LADDER"), "jac_add": ("KP_37", "PK_LADDER")}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

W = 36

_LOCK = threading.Lock()
_LIBS: dict | None = None
_TABLELESS: dict = {}
# what the last build did: directory, seconds, per-library ptxas log
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.exists():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels build only "
        "where the CUDA toolkit is installed"
    )


# the header of the cooperative kernels' programs (ops/lane/coop.py), which
# build() writes into the build directory for csrc/miller.cu, jac_dbl.cu,
# jac_add.cu, chains.cu, tower.cu, inv.cu, htc.cu, fp_mul.cu and ladder.cu
PROGRAMS_H = "coop_programs.h"


def programs_header() -> str:
    from . import coop  # traces the plain bodies (no cycle at call time)

    return coop.header()


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted([*SOURCES.values(), *HEADERS]):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(programs_header().encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile every library not yet built, one nvcc per source, all in
    parallel, after writing PROGRAMS_H into the build directory; raise
    with the compiler's output if any fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    hdr = out / f"{PROGRAMS_H}.{os.getpid()}.tmp"
    hdr.write_text(programs_header())
    os.replace(hdr, out / PROGRAMS_H)
    nvcc = None
    t0 = time.perf_counter()
    jobs = {}
    for lib, src in SOURCES.items():
        so = out / f"lib{lib}.so"
        if so.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out / f"lib{lib}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(out), "-o", str(tmp), str(CSRC / src)]
        jobs[lib] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            so,
        )
    failed = []
    for lib, (proc, tmp, so) in jobs.items():
        log, _ = proc.communicate()
        (out / f"{lib}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {lib} (rc {proc.returncode})\n{log}")
        else:
            os.replace(tmp, so)
    BUILD_INFO.update(
        dir=str(out),
        seconds=time.perf_counter() - t0,
        built=sorted(jobs),
        logs={
            lib: (out / f"{lib}.log").read_text()
            for lib in SOURCES
            if (out / f"{lib}.log").exists()
        },
    )
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(lib: str, folds: np.ndarray, topfm: np.ndarray, out: Path | None = None):
    """Library `lib` of SOURCES (built first if need be), with the constant
    tables `folds` [W, 41] and `topfm` [3, 73], then its INIT_TABLES from
    ops/lane/fp.py, copied into its constant bank. The libraries copy them
    by pointer, so they must be C-ordered int32."""
    from . import fp  # the constant tables (no cycle at call time)

    tables = (folds, topfm, *(getattr(fp, name) for name in INIT_TABLES.get(lib, ())))
    for table in tables:
        if not (table.flags.c_contiguous and table.dtype == np.int32):
            raise ValueError("constant tables must be C-ordered int32")
    so = ctypes.CDLL(str((out or build()) / f"lib{lib}.so"))
    init = getattr(so, f"lh_{lib}_init")
    init.argtypes = [ctypes.c_void_p] * len(tables)
    init.restype = ctypes.c_int
    err = getattr(so, f"lh_{lib}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    torch.cuda.init()
    rc = init(*(t.ctypes.data_as(ctypes.c_void_p) for t in tables))
    if rc:
        raise RuntimeError(f"lh_{lib}_init: {err(rc).decode()} (code {rc})")
    return so


def libs() -> dict:
    """The libraries ENTRIES launch, built at first use (with every other
    library of SOURCES), the lane tables copied in."""
    global _LIBS
    with _LOCK:
        if _LIBS is None:
            from . import fp  # the constant tables (no cycle at call time)

            out = build()
            _LIBS = {
                lib: bind(lib, load(lib, fp.FOLDS_NP, fp.TOPFM_NP, out))
                for lib in sorted({lib for lib, _, _ in ENTRIES.values()})
            }
    return _LIBS


def library(lib: str, argtypes: dict):
    """Library `lib` of SOURCES that takes no tables (sha256, epoch), built
    at first use with every other library and loaded once, with the C
    argument types of its entries from `argtypes` (symbol -> list; each
    entry returns a status, 0 or a CUDA error code)."""
    with _LOCK:
        so = _TABLELESS.get(lib)
        if so is None:
            so = ctypes.CDLL(str(build() / f"lib{lib}.so"))
            for sym, types in argtypes.items():
                fn = getattr(so, sym)
                fn.argtypes, fn.restype = types, ctypes.c_int
            err = getattr(so, f"lh_{lib}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            torch.cuda.init()
            _TABLELESS[lib] = so
    return so


def bind(lib: str, so):
    """Library `lib` loaded as `so`, with the C types of its ENTRIES set."""
    for sym, (name, ins, outs) in ENTRIES.items():
        if name == lib:
            fn = getattr(so, sym)
            fn.argtypes = (
                [ctypes.c_void_p] * (len(ins) + len(outs))
                + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
    return so


def _elem(kind) -> tuple:
    """The element dims between an operand's lead and its lane dim."""
    return (1,) if kind == ROW else (*kind, W)


def _prepare(arrays, fields):
    """Split each operand [*lead, *comp, W, S] by its field's `comp` (a ROW
    operand: [*lead, 1, S]), broadcast the leading (stack) dims and the lane
    dim S across all operands, and check them: CUDA, int32. Returns
    contiguous tensors of shape [*lead, *elem, S], the common lead and S."""
    leads, lanes = [], []
    for a, kind in zip(arrays, fields):
        elem = _elem(kind)
        n = len(elem) + 1
        if a.dim() < n or tuple(a.shape[-n:-1]) != elem:
            want = ", ".join(map(str, elem))
            raise ValueError(f"operand shape {tuple(a.shape)} is not [..., {want}, S]")
        if a.device.type != "cuda":
            raise ValueError(f"operand on {a.device}, kernel needs CUDA")
        if a.dtype != torch.int32:
            raise TypeError(f"operand dtype {a.dtype}, kernel needs int32")
        leads.append(a.shape[:-n])
        lanes.append((a.shape[-1],))
    lead = torch.broadcast_shapes(*leads)
    (S,) = torch.broadcast_shapes(*lanes)
    arrays = [
        a.expand(*lead, *_elem(kind), S).contiguous() for a, kind in zip(arrays, fields)
    ]
    return arrays, lead, S


def launch(symbol: str, arrays, lib=None) -> list:
    """Launch C entry `symbol` on `arrays` on the current stream, from the
    library `lib` (a `bind`-ed handle; default: libs()'); outputs are fresh
    [*lead, *comp, W, S] int32 tensors, each with its own field's comp.
    Raises on any launch error."""
    lib_name, ins, outs_f = ENTRIES[symbol]
    if len(arrays) != len(ins):
        raise ValueError(f"{symbol}: takes {len(ins)} operands, got {len(arrays)}")
    arrays, lead, S = _prepare(arrays, ins)
    K = int(np.prod(lead, dtype=np.int64))
    if K * S == 0:
        raise ValueError(f"{symbol}: empty batch")
    outs = [
        torch.empty((*lead, *comp, W, S), dtype=torch.int32, device=arrays[0].device)
        for comp in outs_f
    ]
    lib = libs()[lib_name] if lib is None else lib
    dev = arrays[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, symbol)(
            *(a.data_ptr() for a in arrays),
            *(o.data_ptr() for o in outs),
            K,
            S,
            stream,
        )
    if rc:
        msg = getattr(lib, f"lh_{lib_name}_error_string")(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc}: {msg}")
    return outs
