"""The port's MSM and KZG slice against the JAX reference's host path.

`msm_g1` / `msm_g1_groups` (lighthouse_tpu_torch/ops/lane/msm.py, run on
the CPU through the kernels' plain bodies) must give the reference's host
MSM (`lighthouse_tpu.crypto.kzg._msm_host`) point for point, and the port's
`device_kzg` must give the reference `Kzg`'s commitment, proof and batch
verdict on the same tiny dev setup, carried across with
`convert.setup_from_reference`, with the batch and single verifications
going through the device pairing (the host pairing is made to raise).
Also pinned: the port never imports jax or the reference, and asking for
CUDA without a GPU raises.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import kzg as ref_kzg
from lighthouse_tpu.crypto.bls import curve as ref_curve
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto.bls import pairing_fast as port_pf
from lighthouse_tpu_torch.crypto.bls.params import G1X, G1Y, R
from lighthouse_tpu_torch.crypto.kzg.device import device_kzg, pairings_product_is_one_device
from lighthouse_tpu_torch.ops.lane import fp, msm

REPO = Path(__file__).resolve().parents[1]
G = (G1X, G1Y)
PTS = [ref_curve.g1_mul(G, k) for k in (3, 5, 7)] + [None]
SCALARS = [0x1234_5678_9ABC_DEF0_1122_3344, 5, 0, R - 1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setups():
    ref_setup = ref_kzg.TrustedSetup.dev(4, with_monomial=False)
    port_setup = convert.setup_from_reference(
        ref_setup.g1_lagrange, ref_setup.g2_tau, ref_setup.roots
    )
    return ref_setup, port_setup


def blob_of(rng, n=4):
    vals = [int(v) % R for v in rng.integers(0, 2**62, size=n)]
    return b"".join(v.to_bytes(32, "big") for v in vals)


def test_msm_g1_matches_reference_host():
    """4 points: a None point and a zero scalar among them."""
    fp.reset_counts()
    assert msm.msm_g1(PTS, SCALARS, device="cpu") == ref_kzg._msm_host(PTS, SCALARS)
    assert not fp.LAUNCHES


def test_msm_g1_groups_matches_reference_host():
    got = msm.msm_g1_groups(PTS, SCALARS, [1, 0, 1, 0], 3, device="cpu")
    want = [
        ref_kzg._msm_host(PTS[1::2], SCALARS[1::2]),
        ref_kzg._msm_host(PTS[0::2], SCALARS[0::2]),
        None,  # an empty group sums to infinity
    ]
    assert got == want


def test_scalars_to_digits_equals_reference():
    from lighthouse_tpu.ops.lane import msm as ref_msm

    sc = SCALARS + [R, R + 7, 2**255 - 1]
    assert np.array_equal(msm.scalars_to_digits(sc), ref_msm.scalars_to_digits(sc))


@pytest.fixture
def no_host_pairing(monkeypatch):
    """Make the port's host pairing raise: a check that reaches it fails."""
    def refuse(pairs):
        raise AssertionError("the host pairing ran where the device pairing should")

    monkeypatch.setattr(port_pf, "pairings_product_is_one_fast", refuse)


def test_device_kzg_slice_matches_reference(setups, no_host_pairing):
    """Commit and prove through the port, then batch-verify two blobs
    through the device pairing; one corrupted byte must flip the verdict."""
    ref_setup, port_setup = setups
    ref = ref_kzg.Kzg(ref_setup)
    port = device_kzg(port_setup, device="cpu")
    rng = np.random.default_rng(4844)
    blobs = [blob_of(rng), blob_of(rng)]

    c0 = port.blob_to_kzg_commitment(blobs[0])
    assert c0 == ref.blob_to_kzg_commitment(blobs[0])
    assert port.commitment_bytes(c0) == ref.commitment_bytes(c0)
    p0, y0 = port.compute_blob_kzg_proof(blobs[0], c0)
    assert (p0, y0) == ref.compute_blob_kzg_proof(blobs[0], c0)

    # the second blob's commitment and proof from the reference (host)
    c1 = ref.blob_to_kzg_commitment(blobs[1])
    p1, _ = ref.compute_blob_kzg_proof(blobs[1], c1)
    args = (blobs, [c0, c1], [p0, p1])
    assert port.verify_blob_kzg_proof_batch(*args) is True
    assert ref.verify_blob_kzg_proof_batch(*args) is True

    bad = bytearray(blobs[1])
    bad[40] ^= 1
    args = ([blobs[0], bytes(bad)], [c0, c1], [p0, p1])
    assert port.verify_blob_kzg_proof_batch(*args) is False


def test_single_verification_matches_reference(setups, no_host_pairing):
    """verify_blob_kzg_proof and verify_kzg_proof through the device
    pairing give the reference Kzg's verdicts."""
    ref_setup, port_setup = setups
    ref = ref_kzg.Kzg(ref_setup)
    port = device_kzg(port_setup, device="cpu")
    blob = blob_of(np.random.default_rng(7))
    c = ref.blob_to_kzg_commitment(blob)
    p, y = ref.compute_blob_kzg_proof(blob, c)
    assert port.verify_blob_kzg_proof(blob, c, p) is True
    assert ref.verify_blob_kzg_proof(blob, c, p) is True
    z = ref._blob_challenge(blob, c)
    assert port.verify_kzg_proof(c, z, (y + 1) % R, p) is False
    assert ref.verify_kzg_proof(c, z, (y + 1) % R, p) is False


def _port_sources():
    pkg = REPO / "lighthouse_tpu_torch"
    # build/ holds what the package generates (kernels, caches), not sources
    sources = [p for p in pkg.rglob("*.py") if "build" not in p.relative_to(pkg).parts]
    return sorted(sources) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_reference():
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "lighthouse_tpu"), (path, name)


def test_package_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import lighthouse_tpu_torch.crypto.kzg.device, lighthouse_tpu_torch.convert\n"
        "import lighthouse_tpu_torch.ops.lane.msm, lighthouse_tpu_torch.ops.lane.tower\n"
        "import lighthouse_tpu_torch.ops.lane.pairing, lighthouse_tpu_torch.ops.lane.kernels\n"
        "import lighthouse_tpu_torch.crypto.bls as bls, lighthouse_tpu_torch.crypto.bls.backends.cuda\n"
        "import lighthouse_tpu_torch.ops.lane.htc, lighthouse_tpu_torch.ops.lane.chains\n"
        "import lighthouse_tpu_torch.ops.lane.jacobian, lighthouse_tpu_torch.tools.ubench_mul\n"
        "import lighthouse_tpu_torch.ops.lane.coop as coop\n"
        "assert bls.verify_signature_sets([], backend='cpu') is False\n"
        "assert all(len(coop.program(slot)) for slot in coop.PROGRAMS)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'lighthouse_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_requested_without_gpu_raises(setups, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        msm.msm_g1(PTS, SCALARS)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_kzg(setups[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        fp.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        pairings_product_is_one_device([])
