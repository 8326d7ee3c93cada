"""The fused columnar epoch pass in PyTorch, with a hand-written CUDA kernel.

Port of lighthouse_tpu/ops/epoch.py: one pass over every validator's
columns computes the balance pipeline of an epoch boundary (inactivity-score
updates, the participation-flag rewards and penalties, the inactivity-leak
penalties, the slashing penalties and the effective-balance hysteresis
decision). `_core` is the plain PyTorch version, the reference's body
operation for operation over int64 and bool tensors, the scalars as 0-d
tensors; csrc/epoch.cu `k_epoch_updates` is the kernel, one thread a
validator. Every division's numerator is non-negative by construction, so
floor and truncating division agree between the two.

`epoch_updates` keeps the reference's contract (numpy columns in, the four
numpy outputs back, bit-identical); `updates` is the tensor entry for
columns already on the card. Both run on CUDA unless the caller names the
CPU, and raise where there is no GPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .lane import fp, kernels

# participation / reward constants (the reference's, ops/epoch.py:47-53)
WEIGHTS = (14, 26, 14)  # source, target, head
WEIGHT_DENOMINATOR = 64
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
INACTIVITY_SCORE_BIAS = 4
INACTIVITY_SCORE_RECOVERY_RATE = 16
INACTIVITY_PENALTY_QUOTIENT = 2**24

# array-input field order (int64 columns, or bool: unslashed_prev, eligible)
_ARRAY_FIELDS = (
    "eff",
    "unslashed_prev",
    "eligible",
    "prev_part",
    "scores",
    "balances",
    "slash_penalty",
)
_BOOL_FIELDS = ("unslashed_prev", "eligible")
# scalar-input field order (do_deltas and leak bool, the rest int64)
_SCALAR_FIELDS = (
    "do_deltas",
    "leak",
    "base_reward_per_inc",
    "total_active_increments",
    "flag_inc_0",
    "flag_inc_1",
    "flag_inc_2",
    "increment",
    "cap",
    "hysteresis_down",
    "hysteresis_up",
)
_BOOL_SCALARS = ("do_deltas", "leak")


def _core(a: dict, s: dict) -> tuple:
    """The fused pass, the plain version of `k_epoch_updates`: int64 and
    bool tensors of one device in `a`, 0-d tensors on it in `s`. Returns
    (new_scores, balances, eff_new, eff_mask)."""
    eff = a["eff"]
    unslashed_prev = a["unslashed_prev"]
    eligible = a["eligible"]
    prev_part = a["prev_part"]
    scores = a["scores"]
    balances = a["balances"]
    slash_penalty = a["slash_penalty"]

    do_deltas = s["do_deltas"]
    leak = s["leak"]
    bri = s["base_reward_per_inc"]
    total_inc = s["total_active_increments"]
    flag_incs = (s["flag_inc_0"], s["flag_inc_1"], s["flag_inc_2"])
    inc = s["increment"]
    cap = s["cap"]
    down = s["hysteresis_down"]
    up = s["hysteresis_up"]

    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=eff.device)

    participated_tgt = unslashed_prev & ((prev_part & (1 << TIMELY_TARGET_FLAG_INDEX)) != 0)

    # --- inactivity-score updates (process_inactivity_updates)
    delta_score = torch.where(
        participated_tgt, -torch.minimum(i64(1), scores), i64(INACTIVITY_SCORE_BIAS))
    new_scores = torch.where(eligible, scores + delta_score, scores)
    recovered = new_scores - torch.minimum(i64(INACTIVITY_SCORE_RECOVERY_RATE), new_scores)
    new_scores = torch.where(eligible & ~leak, recovered, new_scores)
    new_scores = torch.where(do_deltas, new_scores, scores)

    # --- flag rewards/penalties (process_rewards_and_penalties)
    base_rewards = (eff // inc) * bri
    delta = torch.zeros_like(balances)
    for flag_index, weight in enumerate(WEIGHTS):
        has_flag = unslashed_prev & ((prev_part & (1 << flag_index)) != 0)
        rewards = (base_rewards * i64(weight) * flag_incs[flag_index]) // (
            total_inc * i64(WEIGHT_DENOMINATOR))
        delta = torch.where(eligible & has_flag & ~leak, delta + rewards, delta)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalty = base_rewards * i64(weight) // i64(WEIGHT_DENOMINATOR)
            delta = torch.where(eligible & ~has_flag, delta - penalty, delta)

    # inactivity-leak penalties read the updated scores
    inactivity_penalty = (eff * new_scores) // i64(
        INACTIVITY_SCORE_BIAS * INACTIVITY_PENALTY_QUOTIENT)
    delta = torch.where(eligible & ~participated_tgt, delta - inactivity_penalty, delta)
    delta = torch.where(do_deltas, delta, torch.zeros_like(delta))

    balances1 = torch.maximum(balances + delta, i64(0))
    # --- slashing penalties (decrease_balance clamps at zero)
    balances2 = torch.maximum(balances1 - slash_penalty, i64(0))

    # --- effective-balance hysteresis decision (the flat `cap` arm)
    eff_mask = ((balances2 + down) < eff) | ((eff + up) < balances2)
    eff_new = torch.minimum(balances2 - balances2 % inc, cap)
    return new_scores, balances2, eff_new, eff_mask


# ---------------------------------------------------------------- kernel

# the columns, the four outputs, the two bool scalars, the nine int64 ones,
# n and the stream
_ARGTYPES = {"lh_epoch_updates": [ctypes.c_void_p] * (len(_ARRAY_FIELDS) + 4)
             + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_void_p]}


def _check_dict(kind: str, got: dict, fields: tuple) -> None:
    missing = [k for k in fields if k not in got]
    if missing:
        raise TypeError(f"epoch_updates missing {kind}: {missing}")


class EpochKernel:
    """`k_epoch_updates` and its plain version. Called on a dict of 1-d
    columns of one device (int64; bool for unslashed_prev and eligible) and
    a dict of host scalars (Python or numpy values): on the CPU the plain
    body runs; on CUDA the kernel launches (counted in fp.LAUNCHES as
    `epoch_updates`) or raises."""

    name = "epoch_updates"

    def plain(self, arrays: dict, scalars: dict) -> tuple:
        dev = arrays["eff"].device
        if dev.type == "cuda":
            fp.PLAIN_CUDA_CALLS[self.name] += 1
        s = {k: torch.tensor(bool(scalars[k]) if k in _BOOL_SCALARS else int(scalars[k]),
                             device=dev)
             for k in _SCALAR_FIELDS}
        return _core(arrays, s)

    def __call__(self, arrays: dict, scalars: dict) -> tuple:
        _check_dict("arrays", arrays, _ARRAY_FIELDS)
        _check_dict("scalars", scalars, _SCALAR_FIELDS)
        cols = [arrays[k] for k in _ARRAY_FIELDS]
        dev = cols[0].device
        n = cols[0].shape[0]
        for k, c in zip(_ARRAY_FIELDS, cols):
            want = torch.bool if k in _BOOL_FIELDS else torch.int64
            if c.device != dev or c.dtype != want or c.shape != (n,):
                raise ValueError(f"{self.name}: column {k} is {c.dtype} {tuple(c.shape)} on "
                                 f"{c.device}, not {want} ({n},) on {dev}")
        if dev.type == "cpu":
            return self.plain(arrays, scalars)
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for device {dev}")
        outs = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(3)]
        outs.append(torch.empty(n, dtype=torch.bool, device=dev))
        if n == 0:
            return tuple(outs)
        cols = [c.contiguous() for c in cols]
        lib = kernels.library("epoch", _ARGTYPES)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.lh_epoch_updates(
                *(c.data_ptr() for c in cols), *(o.data_ptr() for o in outs),
                *(int(bool(scalars[k])) for k in _BOOL_SCALARS),
                *(int(scalars[k]) for k in _SCALAR_FIELDS[2:]), n, stream)
        if rc:
            msg = lib.lh_epoch_error_string(rc).decode()
            raise RuntimeError(f"lh_epoch_updates: CUDA error {rc}: {msg}")
        fp.LAUNCHES[self.name] += 1
        return tuple(outs)


updates = EpochKernel()


def epoch_updates(arrays: dict, scalars: dict, device=None) -> tuple:
    """Run the fused epoch pass, the reference's contract.

    arrays: int64/bool numpy columns per `_ARRAY_FIELDS`
    scalars: 0-d numpy values per `_SCALAR_FIELDS`
    returns (new_scores, new_balances, eff_new, eff_mask) int64/bool numpy
    arrays, bit-identical to the reference's. Runs on CUDA unless the
    caller names the CPU; raises where there is no GPU."""
    _check_dict("inputs", {**arrays, **scalars}, _ARRAY_FIELDS + _SCALAR_FIELDS)
    dev = fp.resolve_device(device)
    cols = {
        k: torch.from_numpy(np.ascontiguousarray(
            arrays[k], dtype=bool if k in _BOOL_FIELDS else np.int64)).to(dev)
        for k in _ARRAY_FIELDS
    }
    return tuple(o.cpu().numpy() for o in updates(cols, scalars))
