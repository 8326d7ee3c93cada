"""The port's fused epoch pass against the reference's.

lighthouse_tpu_torch/ops/epoch.py keeps the reference's constants and
field orders and its fused pass `_core` as a plain PyTorch body over int64
and bool tensors, the yardstick of csrc/epoch.cu `k_epoch_updates`. Held
here on the CPU: the constants and orders, the body against the
reference's numpy backend on seeded columns with the leak and the deltas
on and off, and a whole `process_epoch` with the port installed at the
reference's backend seam for the test only.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu.consensus import state_transition as st
from lighthouse_tpu.ops import epoch as ref
from lighthouse_tpu_torch.ops import epoch as E
from lighthouse_tpu_torch.ops.lane import fp

_COLUMNAR = Path(__file__).resolve().parent / "test_epoch_columnar.py"


@pytest.fixture(scope="module")
def columnar():
    """tests/test_epoch_columnar.py (its state builder and input draws),
    loaded from its file under a name of its own."""
    spec = importlib.util.spec_from_file_location("epoch_columnar_for_torch", _COLUMNAR)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_and_field_orders_equal_reference():
    assert E._ARRAY_FIELDS == ref._ARRAY_FIELDS
    assert E._SCALAR_FIELDS == ref._SCALAR_FIELDS
    for name in ("WEIGHTS", "WEIGHT_DENOMINATOR", "TIMELY_TARGET_FLAG_INDEX",
                 "TIMELY_HEAD_FLAG_INDEX", "INACTIVITY_SCORE_BIAS",
                 "INACTIVITY_SCORE_RECOVERY_RATE", "INACTIVITY_PENALTY_QUOTIENT"):
        assert getattr(E, name) == getattr(ref, name), name
    assert set(E._BOOL_FIELDS) <= set(E._ARRAY_FIELDS)
    assert set(E._BOOL_SCALARS) <= set(E._SCALAR_FIELDS)


@pytest.mark.parametrize("do_deltas", [True, False])
@pytest.mark.parametrize("leak", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_body_equals_reference(columnar, seed, leak, do_deltas):
    """n = 1,999 seeded columns (tests/test_epoch_columnar.py's draws) with
    the leak and do_deltas set: the four outputs equal the reference's
    numpy backend's, dtype and value, with no launch counted."""
    arrays, scalars = columnar._random_program_inputs(seed)
    scalars = {**scalars, "leak": np.bool_(leak), "do_deltas": np.bool_(do_deltas)}
    want = ref._numpy_backend(arrays, scalars)
    fp.reset_counts()
    got = E.epoch_updates(arrays, scalars, device="cpu")
    assert not fp.LAUNCHES and not fp.PLAIN_CUDA_CALLS
    for w, g in zip(want, got, strict=True):
        assert g.dtype == w.dtype and np.array_equal(w, g)


def test_tensor_entry_checks_its_columns():
    n = 4
    arrays = {k: torch.zeros(n, dtype=torch.bool if k in E._BOOL_FIELDS else torch.int64)
              for k in E._ARRAY_FIELDS}
    scalars = {k: (False if k in E._BOOL_SCALARS else 1) for k in E._SCALAR_FIELDS}
    new_scores, balances, eff_new, mask = E.updates(arrays, scalars)
    assert new_scores.dtype == balances.dtype == eff_new.dtype == torch.int64
    assert mask.dtype == torch.bool and mask.shape == (n,)
    with pytest.raises(ValueError):
        E.updates({**arrays, "eff": arrays["eff"].to(torch.int32)}, scalars)
    with pytest.raises(TypeError):
        E.updates({k: v for k, v in arrays.items() if k != "eff"}, scalars)
    with pytest.raises(TypeError):
        E.epoch_updates({k: v.numpy() for k, v in arrays.items()}, {}, device="cpu")


def test_process_epoch_state_root_through_the_reference_seam(columnar, monkeypatch):
    """The slice as a whole: process_epoch on a 97-validator state ends in
    the same state root with the port's epoch_updates (CPU) installed at
    the reference's backend seam as with the reference's numpy backend."""
    roots, calls = [], []

    def port(arrays, scalars):
        calls.append(len(arrays["eff"]))
        return E.epoch_updates(arrays, scalars, device="cpu")

    for backend in (ref._numpy_backend, port):
        monkeypatch.setattr(ref, "_BACKEND", backend)
        monkeypatch.setattr(ref, "_BACKEND_NAME", "under test")
        spec, state = columnar.build_random_state(21, 97)
        st.process_epoch(spec, state)
        roots.append(state.hash_tree_root())
    assert calls == [97] and roots[0] == roots[1]
