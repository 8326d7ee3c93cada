"""Build, load and launch the hand-written CUDA kernels (csrc/, sm_90a).

Each source in csrc/ becomes one shared library with a plain C interface,
built by its own `nvcc` (all started together), loaded with ctypes. The
build happens at first use, from the package's sources only, into
lighthouse_tpu_torch/build/kernels/<hash of sources and flags>/, which
.gitignore lists; a build already there is reused. Nothing here runs at
import time: CPU-only machines import this module and never call it.

Every C entry takes its operands as [K, W, S] int32 pointers plus K, S and
the CUDA stream, launches on that stream, and returns cudaGetLastError();
`launch` raises on a non-zero code.
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
    "fp_canon": "fp_canon.cu",    # canon_reduce
    "jac_dbl": "jac_dbl.cu",      # jac_dbl_f1
    "jac_add": "jac_add.cu",      # jac_add_f1
}
HEADERS = ("fp_lane.cuh",)

# C entry -> (library, number of inputs, number of outputs)
ENTRIES = {
    "lh_fp_mul": ("fp_mul", 2, 1),
    "lh_fp_sqr": ("fp_mul", 1, 1),
    "lh_fp_canon_reduce": ("fp_canon", 1, 1),
    "lh_jac_dbl_f1": ("jac_dbl", 3, 3),
    "lh_jac_add_f1": ("jac_add", 6, 3),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

W = 36

_LOCK = threading.Lock()
_LIBS: dict | None = None
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


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted([*SOURCES.values(), *HEADERS]):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile every library not yet built, one nvcc per source, all in
    parallel; raise with the compiler's output if any fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = None
    t0 = time.perf_counter()
    jobs = {}
    for lib, src in SOURCES.items():
        so = out / f"lib{lib}.so"
        if so.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out / f"lib{lib}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
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


def libs() -> dict:
    """The loaded libraries, built at first use, constants copied in."""
    global _LIBS
    with _LOCK:
        if _LIBS is None:
            from . import fp  # the constant tables (no cycle at call time)

            out = build()
            loaded = {}
            for lib in SOURCES:
                so = ctypes.CDLL(str(out / f"lib{lib}.so"))
                init = getattr(so, f"lh_{lib}_init")
                init.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                init.restype = ctypes.c_int
                err = getattr(so, f"lh_{lib}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                torch.cuda.init()
                for table in (fp.FOLDS_NP, fp.TOPFM_NP):
                    if not (table.flags.c_contiguous and table.dtype == np.int32):
                        raise ValueError("constant tables must be C-ordered int32")
                rc = init(
                    fp.FOLDS_NP.ctypes.data_as(ctypes.c_void_p),
                    fp.TOPFM_NP.ctypes.data_as(ctypes.c_void_p),
                )
                if rc:
                    raise RuntimeError(
                        f"lh_{lib}_init: {err(rc).decode()} (code {rc})"
                    )
                loaded[lib] = so
            for sym, (lib, n_in, n_out) in ENTRIES.items():
                fn = getattr(loaded[lib], sym)
                fn.argtypes = (
                    [ctypes.c_void_p] * (n_in + n_out)
                    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                )
                fn.restype = ctypes.c_int
            _LIBS = loaded
    return _LIBS


def _prepare(arrays):
    """Broadcast the operands to one [..., W, S] shape and check them:
    CUDA, int32, one device. Returns contiguous tensors, K and S."""
    arrays = torch.broadcast_tensors(*arrays)
    shape = arrays[0].shape
    if len(shape) < 2 or shape[-2] != W:
        raise ValueError(f"operand shape {tuple(shape)} is not [..., {W}, S]")
    for a in arrays:
        if a.device.type != "cuda":
            raise ValueError(f"operand on {a.device}, kernel needs CUDA")
        if a.dtype != torch.int32:
            raise TypeError(f"operand dtype {a.dtype}, kernel needs int32")
    arrays = [a.contiguous() for a in arrays]
    S = shape[-1]
    K = arrays[0].numel() // (W * S) if S else 0
    return arrays, K, S


def launch(symbol: str, arrays, n_out: int) -> list:
    """Launch C entry `symbol` on `arrays` on the current stream; outputs
    are fresh [..., W, S] int32 tensors. Raises on any launch error."""
    lib_name, n_in, n_expect = ENTRIES[symbol]
    if len(arrays) != n_in or n_out != n_expect:
        raise ValueError(f"{symbol}: takes {n_in} operands, gives {n_expect}")
    arrays, K, S = _prepare(arrays)
    if K * S == 0:
        raise ValueError(f"{symbol}: empty batch")
    outs = [torch.empty_like(arrays[0]) for _ in range(n_out)]
    lib = libs()[lib_name]
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
