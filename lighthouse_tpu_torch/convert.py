"""Carry the JAX reference's state into the port, as numpy and Python data.

The tests use these to run both packages on identical inputs and to pin
that the port's own recomputed constants equal the reference's. Nothing
here imports the reference: the caller hands over its arrays and fields.
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto.kzg import TrustedSetup


def constants_from_reference(arrays: dict) -> dict:
    """The reference's FOLDS_NP, TOPFM_NP, KP_37, PK_LADDER (numpy arrays)
    and _SCHED (a dict) -> the port's tensors (int32, CPU) and dict, under
    the port's names: FOLDS, TOPFM, KP_37, PK_LADDER, SCHED."""
    def t(name):
        return torch.from_numpy(np.asarray(arrays[name], dtype=np.int32).copy())

    return {
        "FOLDS": t("FOLDS_NP"),
        "TOPFM": t("TOPFM_NP"),
        "KP_37": t("KP_37"),
        "PK_LADDER": t("PK_LADDER"),
        "SCHED": {str(k): int(v) for k, v in dict(arrays["_SCHED"]).items()},
    }


def tower_constants_from_reference(arrays: dict) -> dict:
    """The reference tower's F2_ONE, F12_ONE, _G1C, _G2C, _G3C (numpy
    arrays) and pairing's _ATE_BITS (a list) -> the port's int32 CPU
    tensors under the names of `ops/lane/tower.consts` (f2_one, f12_one,
    g1c, g2c, g3c) and the bits as a list of ints (ate_bits)."""
    out = {
        name: torch.from_numpy(np.asarray(arrays[ref], dtype=np.int32).copy())
        for name, ref in (
            ("f2_one", "F2_ONE"), ("f12_one", "F12_ONE"),
            ("g1c", "_G1C"), ("g2c", "_G2C"), ("g3c", "_G3C"),
        )
    }
    out["ate_bits"] = [int(b) for b in arrays["_ATE_BITS"]]
    return out


def htc_constants_from_reference(arrays: dict) -> dict:
    """The reference's hash-to-G2, psi and verify constants -> the port's
    names: from ops/lane/htc.py the packed _A, _B, _Z, _NEG_B, _ZA, _Z3,
    _C2, _ROOTS (numpy arrays), the isogeny lists _ISO_XNUM, _ISO_XDEN,
    _ISO_YNUM, _ISO_YDEN, the chain's _E1, _E0 (ints) and _WIN_IDX; the psi
    constants (ops/lane/jacobian.py `_psi_consts()`) as _PSI_CX, _PSI_CY;
    and backends/tpu.py's _G1_GEN_NEG_X, _G1_GEN_NEG_Y. Returns int32 CPU
    tensors (the isogeny lists stacked on a new leading axis), ints, and
    the window indices as a list of ints, under the names without their
    leading underscore."""
    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32).copy())

    out = {}
    for name in ("_A", "_B", "_Z", "_NEG_B", "_ZA", "_Z3", "_C2", "_ROOTS",
                 "_PSI_CX", "_PSI_CY", "_G1_GEN_NEG_X", "_G1_GEN_NEG_Y"):
        out[name[1:]] = t(arrays[name])
    for name in ("_ISO_XNUM", "_ISO_XDEN", "_ISO_YNUM", "_ISO_YDEN"):
        out[name[1:]] = torch.stack([t(a) for a in arrays[name]])
    out["E1"], out["E0"] = int(arrays["_E1"]), int(arrays["_E0"])
    out["WIN_IDX"] = [int(i) for i in np.asarray(arrays["_WIN_IDX"])]
    return out


def batch_from_reference(args) -> tuple:
    """The reference `prepare_batch` output (apk_x, apk_y, sig_x, sig_y,
    t0, t1, rbits, pad; numpy or jax arrays) -> the port's CPU tensors:
    int32, and pad as bool."""
    *ints, pad = (np.asarray(a) for a in args)
    return (*(torch.from_numpy(a.astype(np.int32)) for a in ints),
            torch.from_numpy(pad.astype(bool)))


def lanes_from_reference(arrays) -> tuple:
    """Lane-major int32 arrays of the reference, numpy or jax (a point's
    coordinates, a ladder's bit rows, a ladder step's seven operands, the
    microbenchmark's operands) -> the port's int32 CPU tensors, in order."""
    return tuple(
        torch.from_numpy(np.array(a, dtype=np.int32, order="C", copy=True)) for a in arrays
    )


def ubench_tables_from_reference(arrays: dict) -> dict:
    """The reference microbenchmark's (tools/ubench_pallas.py) FOLDS,
    TOPFM (numpy arrays) and _TROW (a dict) -> C-ordered int32 numpy
    tables and the dict, under the same names: what
    lighthouse_tpu_torch/tools/ubench_mul.py hands its kernels by pointer."""
    out = {
        name: np.ascontiguousarray(np.asarray(arrays[name]), dtype=np.int32)
        for name in ("FOLDS", "TOPFM")
    }
    out["_TROW"] = {int(k): int(v) for k, v in dict(arrays["_TROW"]).items()}
    return out


def setup_from_reference(g1_lagrange, g2_tau, roots) -> TrustedSetup:
    """The port's TrustedSetup over the reference setup's Lagrange basis,
    [tau]G2 and domain (plain ints and tuples), with its packed CPU basis
    made up front (TrustedSetup.g1_basis)."""
    setup = TrustedSetup(
        g1_lagrange=list(g1_lagrange), g2_tau=tuple(g2_tau), roots=list(roots)
    )
    setup.g1_basis("cpu")
    return setup
