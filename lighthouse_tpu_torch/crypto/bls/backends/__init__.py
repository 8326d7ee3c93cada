"""BLS execution backends of the port.

  cpu  - pure-Python control (backends/cpu.py): the verdict oracle
  cuda - the batched device backend (backends/cuda.py): hash-to-G2, the
         ladders, subgroup checks, Miller loops and the final
         exponentiation on the hand-written CUDA kernels (device="cpu"
         runs their plain PyTorch bodies)
"""

from . import cpu

_BACKENDS = {"cpu": cpu}


def get(name: str):
    if name == "cuda" and "cuda" not in _BACKENDS:
        from . import cuda

        _BACKENDS["cuda"] = cuda
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown BLS backend {name!r}") from None
