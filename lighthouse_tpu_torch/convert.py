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


def setup_from_reference(g1_lagrange, g2_tau, roots) -> TrustedSetup:
    """The port's TrustedSetup over the reference setup's Lagrange basis,
    [tau]G2 and domain (plain ints and tuples), with its packed CPU basis
    made up front (TrustedSetup.g1_basis)."""
    setup = TrustedSetup(
        g1_lagrange=list(g1_lagrange), g2_tau=tuple(g2_tau), roots=list(roots)
    )
    setup.g1_basis("cpu")
    return setup
