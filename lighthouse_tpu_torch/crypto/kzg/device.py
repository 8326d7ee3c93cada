"""KZG with the G1 MSM on the GPU.

Port of lighthouse_tpu/crypto/kzg/device.py, MSM half: `device_kzg`
builds a `Kzg` whose `msm` and `msm_multi` seams run the lane-major MSM
(ops/lane/msm.py) on the hand-written CUDA kernels. The `pairing` seam keeps
the validated host pairing (crypto/bls/pairing_fast.py); the reference's
device pairing program is not ported yet.
"""

from __future__ import annotations

from ...ops.lane import fp, msm as dev_msm
from . import Kzg, TrustedSetup


def device_kzg(setup: TrustedSetup = None, device=None) -> Kzg:
    """A Kzg service whose MSMs run on `device` (CUDA unless named; asking
    for CUDA without a GPU raises). Commitments and proofs, whose points
    are the setup's Lagrange basis, reuse the basis packed once."""
    dev = fp.resolve_device(device)
    setup = setup or TrustedSetup.dev()

    def msm(points, scalars):
        if points is setup.g1_lagrange:
            return dev_msm.msm_g1_packed(setup.g1_basis(dev), scalars)
        return dev_msm.msm_g1(points, scalars, device=dev)

    def msm_multi(points, scalars, group_ids, n_groups):
        return dev_msm.msm_g1_groups(points, scalars, group_ids, n_groups, device=dev)

    return Kzg(setup, msm=msm, msm_multi=msm_multi)
