#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: its KZG slice, its main path
(BLS batch signature verification), the paths of the last six TPU
kernels (the per-lane ladders, the unfused Miller doubling, the Fp-product
microbenchmark) and a 1M-validator state's roots and epoch pass, holding
every kernel against its plain PyTorch version.

Run from the repository root on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit (nvcc):

    python3 chip_smoke.py

It imports lighthouse_tpu_torch only (never jax or lighthouse_tpu) and
needs one card. Phases, each with its seconds; any failure raises and exits
non-zero before the last line:

1. card: the `nvidia-smi --query-gpu=name,power.limit` line.
2. build: the thirteen CUDA libraries from csrc/ (one nvcc each, in
   parallel), with ptxas' registers / stack frame / spill bytes per
   function; for the twenty-three cooperative kernels (csrc/coop.cuh:
   miller_dbl_iter, miller_add_iter, cyc_sqr, jac_dbl_f1, jac_add_f1,
   add_exact_f1, jac_dbl_f2, jac_add_f2, g1_win_step, g2_win_step, f2mul,
   f2sqr, f6mul, f12mul, f12sqr, f12mul_034, the Fermat inversions inv_w4,
   inv_bin,
   hash-to-G2's ratio_chain, mul and sqr, one warp per lane element, and
   the ladder steps ladder_step_f1, ladder_step_f2, each the add's and the
   doubling's programs in one block),
   their ptxas line, the dynamic shared memory their library launches
   them with (held equal to their programs' layout) and their programs'
   shape (stages, jobs, rows, warps, words).
3. kernels: mul, sqr, canon_reduce, jac_dbl_f1, jac_add_f1 and
   add_exact_f1 against their plain bodies on seeded operands at
   [36,4096], [2,36,128], [36,4097]; the cooperative jac_dbl_f1,
   jac_add_f1 (slice 12) and add_exact_f1 (slice 13) also at the commit
   MSM's lane-sum widths 2,048 ... 1 as [36, S] (the add with P1, P2,
   both or neither at infinity at each width, below 4 lanes a hold per S
   of the cases; the exact add with its planted lanes of real points,
   EXACT_CASES, the same way, and the lanes that took each of its five
   cases counted over all its holds, each case at least once; the
   doubling once a width), in device ms and bound at 1 ... 4,096 lanes
   with the latency floor at S = 1; the cooperative mul also at S = 1,
   2, 1,024 and at its paths' stacks 12 x 1, 2 x 1 and 2 x
   1,024 (MUL_S), and the cooperative sqr at S = 1, 128 and 1,024 (SQR_S:
   its one launch a verify at buckets 128 and 1024), in device ms and
   bound there; slice 4's norm3, f12sqr,
   f12mul_034, ladder_step_f1,
   ladder_step_f2, ubench_mul and ubench_mul_chain (R = 3) on seeded
   operands at those widths and at S = 1 and 2 (infinity lanes on both
   sides of a ladder step, its bit row all 0, all 1 and mixed), timed at
   S = 4096; the cooperative ladder steps also at S = 1024 and at S = 1
   and 2 on every (bit, accumulator at infinity, addend at infinity), in
   device ms and bound at S = 1, 2 and 1024 and, every bit set, at S = 1,
   1024 and 4096; the cooperative f12sqr and f12mul_034 also at S = 1024
   and 128 (F12_S: the unfused doubling's width), in device ms and bound
   at S = 1, 2, 1024 and 128; the
   inversions inv_w4 and inv_bin on seeded 2-unit operands (a zero lane:
   0 maps to 0) at those widths and at S = 1024, timed at S = 4096 and in
   device ms at S = 1, 2 and 1024, beside their bound and, at S = 1, the
   latency floor of their serial stages; canonical (canon_reduce, the
   ripples and the subtract ladder in one launch) on seeded differences
   of products at those widths and at S = 1, 2, 1024 and the verify's
   stacks 2 x 1, 2 x 1,024 and 8 x 2,048 (CANON_S), on its edge operands
   (0, p, -p, p - 1, 2p, the two ends of the ladder's window) and on its
   long chains (offset values p * 2^k - 1, p * 2^k, p * 2^k + 1 for k =
   0 .. 6; limbs all MASK and all -MASK), timed at S = 4096 and in device
   ms and bound at CANON_S, with the latency floor of its chain at S = 1;
   reduce_light on seeded lazy sums at 2 x 2,048, 6 x 1 and 4,097 (RL_S),
   in device ms and bound there, with its floor; then every kernel of
   the pairing check (mul, canonical, reduce_light, f2mul, f2sqr, f6mul,
   f12mul, miller_dbl_iter, miller_add_iter, cyc_sqr, inv_bin) against
   theirs on operands recorded from a real Miller loop, final
   exponentiation and == 1 test over 4097 seeded pairs, and canon_reduce,
   which no path launches since its body runs inside canonical, on
   canonical's: every distinct operand layout each kernel met there
   (shapes, and broadcast views such as frob2's gamma table or the first
   iteration's expanded 1), each at S = 1, 2, 4097 and at 128 lanes with
   a leading stack of 2 (the cooperative mul, miller_dbl_iter,
   miller_add_iter, cyc_sqr, f2mul, f2sqr, f6mul, f12mul and inv_bin also
   at S = 1024, the BLS bucket-1024 width, and f2mul and f2sqr at S = 2048 and a
   stack of 4 x 2048, their widths in a bucket-1024 verify). All
   torch.equal. Each timed at S = 4096 (profiler device ms, CUDA-event
   call ms, plain ms, bound) and at the pairing path's own width; the
   cooperative ones also in device ms and bound at S = 1, 2 and 1024
   (f2mul and f2sqr also at 2048 and 4 x 2048, on one element of the
   recorded stack). canonical's device ms at S = 4096 and per MSM (the
   `glue` line); a small MSM against the host group law.
4. pairing128: a 128-lane Miller loop against the host Miller loop on 4
   lanes; the product over 64 bilinear couples is 1, with one Q swapped it
   is not, with a few couples masked by p_inf it still is.
5. e2e: the mainnet setup; the fixture blob's commitment and proof equal
   to c-kzg's bytes; 5 more seeded blobs committed and proved (a Deneb
   block's 6); the batch verifies and fails with one byte flipped; the
   fixture blob's own proof verifies and fails with one byte flipped. The
   launch counters are zeroed just before and read just after, and every
   KZG kernel must have run there with no plain body on a CUDA tensor.
   Then, apart: the per-MSM and per-pairing-check launch counts against
   the counts read off the code (each canonical() one `canonical`
   launch, each G1 exact add one `add_exact_f1`), the pairing seam (device against host, the same verdict), one
   commitment and one pairing check profiled for their device share and
   torch ops.
6. bls: jac_dbl_f2, jac_add_f2, g1_win_step, g2_win_step against their
   plain bodies on seeded operands (infinity lanes, every digit) at the
   phase 3 widths, timed at S = 4096; all four, cooperative, also at S =
   1024 and at S = 1 and 2 (every combination of digit, accumulator or P1
   at infinity and entry or P2 at infinity, a hold per lane or pair), in
   device ms and bound at S = 1, 2 and 1024, with the latency floor at S =
   1; ratio_chain against its plain body on seeded Fp2 operands (lane 0
   zero) at the phase 3 shapes and S = 1, 2, 256, 2048 (buckets 128 and
   1024 hash twice their width) and 4096, in device ms and bound at those
   widths, with its latency floor at S = 1; all 18 kernels against theirs
   on every operand layout a real bucket-128 verify meets (canon_reduce on
   canonical's), at S = 1, 2, the layout's own width and 2 x 128, each
   timed at the path's width. Then
   the BLS main path, counters zeroed just before and read just after:
   tests/test_tpu_backend.py's verdict matrix at bucket 128 through
   `verify_signature_sets(..., backend="cuda")`, each case against the
   `cpu` backend on the same seeded scalars; a 1,024-set gossip batch (64
   committees of 16 validators, keys cached in lighthouse_tpu_torch/build/)
   verified three times, True, and with one signature moved, False. Every
   kernel must have run there, with no plain body on a CUDA tensor, and
   the launches per verify must equal the reference's dispatch census op
   by op at buckets 128 and 1024, each Fermat inversion's chain and
   hash-to-G2's ratio chain in one launch (inv_w4, inv_bin, ratio_chain),
   the G1 exact add in one (add_exact_f1), each canon_reduce a canonical
   launch. The wall per verify split into
   host packing and device, the sets/s at 1024, and the device share of
   one 1024 verify from the profiler, with each kernel's device ms in it
   (`device_totals`: each device event counted once, beside the sum over
   every profiler entry and the torch glue's share) and its torch ops
   (the profiler's aten:: entries).
7. ladders, slice 4's paths, each run with the counters zeroed just
   before and read just after (no other launch, no plain body on a CUDA
   tensor): on the 1,024-set batch of phase 6 (bucket 1024, the last
   lane's signature moved off G2), J.scalar_mul over G1 (64
   ladder_step_f1) and J.scalar_mul_with_static over G2 with the static
   |u| (64 ladder_step_f2, 6 jac_add_f2); [r]apk and [r]S jac_eq to the
   windowed chains' on every lane, the static accumulator torch.equal to
   scalar_mul_static, psi(S) == -[|u|]S on the 1,023 real lanes and not
   on the lane off G2; the walls of each ladder beside its windowed
   counterpart, and the device ms of one run of each (`device_totals`),
   with each kernel's share (the 64 ladder steps'). The unfused Miller
   doubling: f12mul_034(f12sqr(f), c0, c1, c4) through the two
   standalone kernels on all 63 doubling
   iterations of a 128-lane Miller loop (phase 4's pairs), torch.equal to
   miller_dbl_iter's f, and the device ms of one run of the 63 beside
   the 63 fused miller_dbl_iter launches on the same operands
   (`device_totals`), each kernel's share. The microbenchmark at S =
   110,592 and R = 40: one product, R chained products in one launch and
   the lane baseline (norm3 on both operands, R launches of mul), against
   Python ints, the device ms and bound of the chain (R = 40), the single
   product and norm3 at S = 4,096 and 110,592 (norm3 also with the L2
   cleared before each launch), then its
   ms per launch and per element-product (lighthouse_tpu_torch.tools.
   ubench_mul.run), there and at 1,024 lanes.
8. state: a registry of 2^20 - 5 validators from a seed (a real state's
   column shapes; a count whose trees meet layers of odd width) packed on the host into big-endian chunk words and
   copied to the card; then, the counters zeroed just before and read
   just after, its cold roots through ops/lane/merkle.py (the pubkeys'
   2-chunk trees, the Validators' 8-field trees, the registry's tree to
   2^40 with the length mixed in, balances' and inactivity_scores' trees:
   60 launches of k_sha256_pairs, one a level with more than one node)
   and one epoch pass (k_epoch_updates); 1,024 sampled element roots
   against hashlib, the registry's upper tree over the device's element
   roots and both lists' roots against a host merkleize; host-pack s,
   host-to-device s, device ms counted once (`device_totals`), launches,
   compressions and their operations bound, each on a line of its own;
   k_sha256_pairs against its plain body at 1, 261 and 32,768 seeded nodes
   and on the path's operands at its pubkey level (a pair a validator) and
   its widest level (the element trees' first, 4 pairs a validator, read
   in place), in device ms and bound at each; k_epoch_updates against its
   plain body on every validator with the leak off, on and do_deltas
   false, in device ms warm and with the L2 cleared; the numpy entries
   compress_pairs and epoch_updates on the card against the tensor
   entries, in call ms beside the epoch pass's plain body on the host.
9. the `kernels` JSON line (launches: the BLS main path's for its kernels,
   slice 4's paths' and phase 8's for theirs, 0 for canon_reduce and
   jac_add_f1, which no path launches; launches_kzg: phase 5's;
   launches_slice4: phase 7's; launches_state: phase 8's; row 23 of the
   TPU-kernel table is two entries, ubench_mul and ubench_mul_chain; `ptxas`: each kernel's registers,
   stack, spills and static shared memory; `launch_smem`: the cooperative
   kernels' dynamic shared memory, as each library reports it; the
   cooperative kernels' device ms and bound at S = 1, 2 and 1024,
   canonical's at CANON_S and reduce_light's at RL_S, f2mul's and
   f2sqr's also at 2048 and 4x2048, mul's at 12x1, 2x1 and 2x1024, sqr's
   at 1, 128 and 1024 (not 2), the ladder steps' also with every bit set,
   and the latency floor at S = 1; the ladder steps' device ms over phase
   7's 64 launches; the microbenchmark's two kernels' and norm3's device
   ms and bound at 4096 and 110592, norm3's also cold; k_sha256_pairs'
   device ms and bound at each node count held, k_epoch_updates' warm
   and cold);
10. the `ok` JSON line (last).
"""

from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "tests" / "vectors" / "external" / "test_blobs_bundle.ssz"
SHAPES = [(36, 4096), (2, 36, 128), (36, 4097)]
SEED = 4844
DEVICE = "cuda"

# H100 SXM peaks: 3.35 TB/s HBM3; int32 at half the 67 TFLOP/s float32
# (non-tensor) rate, since an SM issues 64 int32 vs 128 float32 lanes per
# clock: 33.5e12 int32 ops/s, a multiply-add counted as 2.
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 33.5e12

CSRC = "lighthouse_tpu_torch/csrc/"
KERNELS = {
    # name: (source, replaced Pallas kernel)
    "mul": (CSRC + "fp_mul.cu", "lighthouse_tpu/ops/lane/fp.py:440"),
    "sqr": (CSRC + "fp_mul.cu", "lighthouse_tpu/ops/lane/fp.py:441"),
    "canon_reduce": (CSRC + "fp_canon.cu", "lighthouse_tpu/ops/lane/fp.py:444"),
    # canonical() in one launch: `canon_reduce` (fp.py:444) and the
    # ripples and subtract ladder the reference's `canonical` (fp.py:488)
    # runs around it as glue
    "canonical": (CSRC + "fp_canon.cu", "lighthouse_tpu/ops/lane/fp.py:488"),
    "jac_dbl_f1": (CSRC + "jac_dbl.cu", "lighthouse_tpu/ops/lane/jacobian.py:163"),
    "jac_add_f1": (CSRC + "jac_add.cu", "lighthouse_tpu/ops/lane/jacobian.py:165"),
    # the G1 exact add in one launch: the reference's add(FP1, ..., exact=True)
    # (jacobian.py:267) over the Pallas kernels mul, sqr, canon_reduce
    # (fp.py:440, :441, :444), jac_dbl_f1 and jac_add_f1 (jacobian.py:163, :165)
    "add_exact_f1": (CSRC + "jac_add.cu", "lighthouse_tpu/ops/lane/jacobian.py:267"),
    "reduce_light": (CSRC + "tower.cu", "lighthouse_tpu/ops/lane/fp.py:442"),
    "f2mul": (CSRC + "tower.cu", "lighthouse_tpu/ops/lane/tower.py:217"),
    "f2sqr": (CSRC + "tower.cu", "lighthouse_tpu/ops/lane/tower.py:218"),
    "f6mul": (CSRC + "tower.cu", "lighthouse_tpu/ops/lane/tower.py:219"),
    "f12mul": (CSRC + "tower.cu", "lighthouse_tpu/ops/lane/tower.py:220"),
    "miller_dbl_iter": (CSRC + "miller.cu", "lighthouse_tpu/ops/lane/pairing.py:127"),
    "miller_add_iter": (CSRC + "miller.cu", "lighthouse_tpu/ops/lane/pairing.py:128"),
    "cyc_sqr": (CSRC + "miller.cu", "lighthouse_tpu/ops/lane/pairing.py:257"),
    "jac_dbl_f2": (CSRC + "jac_dbl.cu", "lighthouse_tpu/ops/lane/jacobian.py:164"),
    "jac_add_f2": (CSRC + "jac_add.cu", "lighthouse_tpu/ops/lane/jacobian.py:166"),
    "g1_win_step": (CSRC + "chains.cu", "lighthouse_tpu/ops/lane/chains.py:137"),
    "g2_win_step": (CSRC + "chains.cu", "lighthouse_tpu/ops/lane/chains.py:138"),
    "norm3": (CSRC + "fp_canon.cu", "lighthouse_tpu/ops/lane/fp.py:443"),
    "f12sqr": (CSRC + "tower.cu", "lighthouse_tpu/ops/lane/tower.py:221"),
    "f12mul_034": (CSRC + "tower.cu", "lighthouse_tpu/ops/lane/tower.py:222"),
    "ladder_step_f1": (CSRC + "ladder.cu", "lighthouse_tpu/ops/lane/jacobian.py:167"),
    "ladder_step_f2": (CSRC + "ladder.cu", "lighthouse_tpu/ops/lane/jacobian.py:168"),
    # row 23 of the TPU-kernel table is two kernels, `_kernel` and `_kernel_chain`
    "ubench_mul": (CSRC + "ubench_mul.cu", "tools/ubench_pallas.py:85"),
    "ubench_mul_chain": (CSRC + "ubench_mul.cu", "tools/ubench_pallas.py:93"),
    # the Fermat inversions, each in one launch: the chains of `mul` and
    # `sqr` (fp.py:440-441) that chains.inv and fp.inv launched op by op
    "inv_w4": (CSRC + "inv.cu", "lighthouse_tpu/ops/lane/fp.py:441"),
    "inv_bin": (CSRC + "inv.cu", "lighthouse_tpu/ops/lane/fp.py:441"),
    # hash-to-G2's ratio chain in one launch: the chain of `f2sqr` and
    # `f2mul` (tower.py:217-218) that htc.ratio_chain launched op by op
    "ratio_chain": (CSRC + "htc.cu", "lighthouse_tpu/ops/lane/htc.py:98"),
    # the two programs the reference jits outside Pallas: state hashing's
    # merkle-node compression (on its device) and the fused epoch pass
    # (pinned to its host's CPU)
    "sha256_pairs": (CSRC + "sha256.cu", "lighthouse_tpu/ops/lane/sha256.py:150"),
    "epoch_updates": (CSRC + "epoch.cu", "lighthouse_tpu/ops/epoch.py:83"),
}
# the kernels of the KZG path (slices 1, 2, 7, 11 and 13), of the BLS main
# path (slices 1-3, 7, 9, 11 and 13) and of slice 4's paths (the ladders,
# the unfused Miller doubling, the microbenchmark); canon_reduce, whose
# body runs inside canonical since slice 11, and jac_add_f1, whose program
# runs inside add_exact_f1 since slice 13 (no path makes a G1 add that is
# not exact), are held but launched on no path. sqr runs on the BLS path
# only: the KZG path's (the MSM's collision checks) went into add_exact_f1
_PAIRING = ("reduce_light", "f2mul", "f2sqr", "f6mul", "f12mul", "miller_dbl_iter",
            "miller_add_iter", "cyc_sqr", "inv_bin")
KZG_KERNELS = ("mul", "canonical", "jac_dbl_f1", "add_exact_f1", *_PAIRING)
BLS_KERNELS = (*KZG_KERNELS, "sqr", "jac_dbl_f2", "jac_add_f2", "g1_win_step",
               "g2_win_step", "inv_w4", "ratio_chain")
SLICE4_KERNELS = ("norm3", "f12sqr", "f12mul_034", "ladder_step_f1", "ladder_step_f2",
                  "ubench_mul", "ubench_mul_chain")
# canonical() is one kernel, `canonical`, where the reference launches
# `canon_reduce` and runs the ripples and the ladder as XLA glue: each
# canon_reduce launch of a count made op by op is one canonical launch,
# and canon_reduce is held on the operands canonical met (the same input)
FUSED = {"canon_reduce": "canonical"}
# The G1 exact add is one kernel, `add_exact_f1`, where the reference
# launches jac_add_f1, the collision check's 2 sqr and 6 mul, its 2
# canonical() (canon_reduce) and a jac_dbl_f1: a count made op by op folds
# those into one add_exact_f1 launch per G1 exact add
EXACT_ADD = {"jac_add_f1": 1, "sqr": 2, "mul": 6, "canon_reduce": 2, "jac_dbl_f1": 1}
OFF_PATH = (*FUSED, "jac_add_f1")
# phase 8's path: a 1M-validator state's roots and its epoch pass
STATE_KERNELS = ("sha256_pairs", "epoch_updates")
assert sorted(BLS_KERNELS + SLICE4_KERNELS + OFF_PATH + STATE_KERNELS) == sorted(KERNELS)
SEEDED = ("mul", "sqr", "canon_reduce", "jac_dbl_f1", "jac_add_f1", "add_exact_f1")
# the inversions, held on seeded operands at SHAPES and CHAIN_S
CHAIN_KERNELS = ("inv_w4", "inv_bin")
CHAIN_S = (1, 2, 1024)
# the ratio chain, held on seeded operands at SHAPES and RATIO_S and timed
# at RATIO_S: a verify runs it at twice the bucket's width (both draws)
RATIO_S = (1, 2, 256, 2048, 4096)
# canonical, held on seeded differences of products at SHAPES and CANON_S
# and on its edge and long-chain operands, and timed at S=4096 and CANON_S:
# its widths in a bucket-1024 verify are 1 to 2 x 2,048 lanes (the lane
# sum's 2 x 1 .. 2 x 512, the G2 exact adds' 2 x 1,024, hash-to-G2's 8 x
# 2,048 and 2 x 2,048, final_exp's 12 x 1)
CANON_S = (1, 2, 1024, (2, 1), (2, 1024), (8, 2048))
# reduce_light, held on seeded lazy sums at RL_S beside its recorded holds
# and timed there: hash-to-G2's map runs it at 2 x 2,048, the final
# exponentiation's Fp12 inversion at 6 x 1; 4,097 lanes a ragged block
RL_S = ((2, 2048), (6, 1), 4097)
# the dependent chains of one lane element's thread, at 4 cycles an
# operation. canonical (and add_exact_f1's zero tests of H and R):
# canon_reduce's 8 dependent operations, then 8 ripples of 37 dependent
# add-and-shift pairs (each ladder round waits for the last round's
# borrow). reduce_light: two folds, each a multiply-add on the last one's
# limb 35, then its carry pass, the top limb's shift and a multiply-add.
CANON_CHAIN_OPS = 8 + 8 * 37 * 2
RL_CHAIN_OPS = 2 + 2
# every kernel of the pairing check, held on operands recorded from a real
# one (canon_reduce on canonical's)
RECORDED = ("mul", "canonical", "canon_reduce", *_PAIRING)


def _chain_launches() -> dict:
    """The launches of `mul` and `sqr` each inversion replaces, read off
    the chains for p - 2 (ops/lane/chains.py pow_const_w4: the table's sqr
    and 3 stacked mul calls, then 4 sqr and 1 mul a window; ops/lane/fp.py
    pow_const: a sqr on every bit, a mul on each set bit), and those of
    `f2sqr` and `f2mul` the ratio chain replaces (ops/lane/htc.py: the
    table's f2sqr, f2mul and stacked f2mul, then 2 f2sqr and 1 f2mul a
    window)."""
    from lighthouse_tpu_torch.crypto.bls.params import P
    from lighthouse_tpu_torch.ops.lane import chains, htc

    e, windows = P - 2, len(chains.window_digits(P - 2))
    return {"inv_w4": {"sqr": 1 + 4 * windows, "mul": 3 + windows},
            "inv_bin": {"sqr": e.bit_length(), "mul": bin(e).count("1")},
            "ratio_chain": {"f2sqr": 1 + 2 * htc._NW, "f2mul": 2 + htc._NW}}


def _with_chains(per_op: dict, chains: dict, exact_adds: int = 0) -> dict:
    """Launches counted op by op, each of `chains` ({name: calls}) folded
    into one launch of its kernel, each of `exact_adds` G1 exact adds into
    one add_exact_f1 launch (EXACT_ADD), and each canonical() into one
    (FUSED)."""
    out = dict(per_op)
    for chain, n in chains.items():
        for op, per in _chain_launches()[chain].items():
            out[op] -= n * per
        out[chain] = out.get(chain, 0) + n
    for op, per in EXACT_ADD.items():
        out[op] = out.get(op, 0) - exact_adds * per
    out["add_exact_f1"] = out.get("add_exact_f1", 0) + exact_adds
    for op, fused in FUSED.items():
        out[fused] = out.get(fused, 0) + out.pop(op, 0)
    return {k: v for k, v in out.items() if v}


# launches per msm_g1 at a 4096-lane bucket, read off the code
# (ops/lane/msm.py): 256 window doublings and 90 exact adds, each, op by
# op, a jac_add_f1, 2 sqr, 6 mul, the collision check's 2 canonical() and
# a jac_dbl_f1; each exact add one add_exact_f1
PER_MSM = _with_chains({"jac_add_f1": 90, "sqr": 180, "mul": 540, "canon_reduce": 180,
                        "jac_dbl_f1": 346}, {}, exact_adds=90)


def check_launches() -> dict:
    """Launches per 2-lane pairing check (ops/lane/pairing.py, read off the
    code): 63 doubling and 5 addition iterations; one lane-product f12mul;
    final_exp's f12inv (4 f6mul, 1 reduce_light, f6inv's 1 f2sqr + 3 f2mul,
    f2inv's 2 mul + fp.inv's chain), frob1's f2mul, 2 frob2 mul, 10 f12mul,
    5 x cyc_pow_u (63 cyc_sqr + 5 f12mul each); f12_eq_one's one
    canonical()."""
    op_by_op = {"miller_dbl_iter": 63, "miller_add_iter": 5, "f12mul": 36, "cyc_sqr": 315,
                "f6mul": 4, "f2mul": 4, "f2sqr": 1, "reduce_light": 1, "mul": 233,
                "sqr": 381, "canon_reduce": 1}
    return _with_chains(op_by_op, {"inv_bin": 1})


# the cooperative kernels (csrc/coop.cuh), by the library that
# launches them: also held at the bucket-1024 width and read in device ms
# at the widths their paths run
COOP_LIBS = {"miller_dbl_iter": "miller", "cyc_sqr": "miller", "jac_dbl_f2": "jac_dbl",
             "jac_add_f2": "jac_add", "g1_win_step": "chains", "g2_win_step": "chains",
             "f12mul": "tower", "inv_w4": "inv", "inv_bin": "inv", "ratio_chain": "htc",
             "miller_add_iter": "miller", "f2mul": "tower", "f2sqr": "tower",
             "jac_dbl_f1": "jac_dbl", "jac_add_f1": "jac_add", "add_exact_f1": "jac_add",
             "f6mul": "tower", "mul": "fp_mul", "sqr": "fp_mul", "ladder_step_f1": "ladder",
             "ladder_step_f2": "ladder", "f12sqr": "tower", "f12mul_034": "tower"}
REDESIGNED = tuple(COOP_LIBS)
REDESIGNED_S = (1, 2, 1024)
# mul's widths on the paths beyond those, each a stack (K, S): frob2's 12 x
# 1 and the final exponentiation's f2inv 2 x 1 (a verify's finish and the
# KZG check), the affine conversions' f2inv 2 x 1,024 (1 x 1,024: S=1024);
# held there on seeded operands [K, 36, S] and read in device ms
MUL_S = (*REDESIGNED_S, (12, 1), (2, 1), (2, 1024))
# sqr's: one lane, and its one launch a verify, 1 x 128 and 1 x 1,024
# (_to_affine_g1 at the bucket's width); held there on seeded operands and
# read in device ms
SQR_S = (1, 128, 1024)
# the kernels held and read at widths of their own beyond the phase 3 shapes
SEEDED_S = {"mul": MUL_S, "sqr": SQR_S}
# f2mul's and f2sqr's widths in a bucket-1024 verify beyond those: 2,048
# lanes and a stack of 4 x 2,048 (K, S); held there and read in device ms
# on one element of the recorded stack (Fp2 operands [2, W, S])
F2_S = (*REDESIGNED_S, 2048, (4, 2048))
F2_KERNELS = ("f2mul", "f2sqr")
# f12sqr's and f12mul_034's width beyond those: 128 lanes, where phase 7's
# unfused Miller doubling runs them; held there on seeded operands and
# read in device ms
F12_S = (*REDESIGNED_S, 128)
F12_KERNELS = ("f12sqr", "f12mul_034")
# the G1 group kernels' widths in a 4,096-lane commit MSM (ops/lane/msm.py):
# its walk at 4,096 lanes, its lane sum at 2,048 ... 1; held there (the add
# on every infinity combination, ADD_COMBOS; the exact add on its planted
# lanes, EXACT_CASES) and read in device ms
MSM_S = tuple(1 << i for i in range(13))
MSM_KERNELS = ("jac_dbl_f1", "jac_add_f1", "add_exact_f1")
# (digit, P1 at infinity, P2 at infinity): an add's four cases
ADD_COMBOS = [(0, a, b) for a in (0, 1) for b in (0, 1)]
# the exact add's planted lanes (P1, P2), real points from seeded scalars
# (random operands never collide): P + P with one Z; P + P with Z2 = l Z1
# (H === 0, its limbs not 0); P + (-P) with one Z and with Z2 = l Z1;
# infinity as P1, as P2 and as both; P + Q
EXACT_CASES = ("dbl", "dbl_rescaled", "neg", "neg_rescaled", "inf_p1", "inf_p2", "inf_both",
               "sum")
# the exact add's five cases, in the order its select takes them
# (jacobian._add_exact_select)
EXACT_BRANCHES = ("double", "infinity", "p2", "p1", "sum")
# the dependent multiply-adds of one warp product (a column's 36, a fold's
# 38), at 4 cycles each: a stage of a cooperative program at one lane
# element takes at least this many cycles of the SM clock
JOB_CHAIN_CYCLES = (36 + 38) * 4
# every (digit, accumulator at infinity, entry at infinity) of a window step
WIN_COMBOS = [(d, a, e) for d in range(4) for a in (0, 1) for e in (0, 1)]
# every (bit, accumulator at infinity, addend at infinity) of a ladder step
LADDER_COMBOS = [(b, a, e) for b in (0, 1) for a in (0, 1) for e in (0, 1)]
# per kernel k_<name>: ptxas registers, static shared memory, stack, spills
PTXAS: dict = {}
# per cooperative kernel: the dynamic shared memory (bytes) its blocks launch
# with, read from its library (lh_<library>_launch_smem)
LAUNCH_SMEM: dict = {}
_PTXAS_FIELDS = {"registers": r"Used (\d+) registers", "smem": r"(\d+) bytes smem",
                 "stack": r"(\d+) bytes stack frame", "spill_stores": r"(\d+) bytes spill stores",
                 "spill_loads": r"(\d+) bytes spill loads"}
# the lane width each recorded kernel runs at on the KZG pairing path
# (the rest: 1, after the lane product)
PATH_S = {"miller_dbl_iter": 2, "miller_add_iter": 2}
# slice 3's new kernels, held on seeded operands like SEEDED
BLS_SEEDED = ("jac_dbl_f2", "jac_add_f2", "g1_win_step", "g2_win_step")
# launches per BLS verify at buckets 128 and 1024 in the reference: its
# dispatch census (lighthouse_tpu.ops.costs.verify_kernel_costs; totals
# 3,728 and 3,767 in tests/budgets/kernel_costs.json), op by op
_PER_VERIFY_COMMON = {
    "sqr": 1539, "mul": 543, "cyc_sqr": 315, "miller_dbl_iter": 126,
    "g1_win_step": 32, "g2_win_step": 32, "reduce_light": 17, "miller_add_iter": 10,
    "f6mul": 4, "jac_dbl_f1": 2, "jac_add_f1": 1,
}
REFERENCE_PER_VERIFY = {
    128: {**_PER_VERIFY_COMMON, "f2sqr": 428, "f2mul": 358, "jac_dbl_f2": 208,
          "f12mul": 43, "canon_reduce": 38, "jac_add_f2": 32},
    1024: {**_PER_VERIFY_COMMON, "f2sqr": 434, "f2mul": 376, "jac_dbl_f2": 211,
           "f12mul": 46, "canon_reduce": 44, "jac_add_f2": 35},
}


def verify_launches(bucket: int) -> dict:
    """The reference's census with each Fermat inversion in one launch:
    3 chains.inv (_to_affine_g1 and _to_affine_g2 at the bucket's width,
    finish_phase's _to_affine_g2 at 1 lane) and final_exp's fp.inv; with
    hash-to-G2's ratio chain in one launch; with the one G1 exact add
    (scalar_mul_w2's table for [r]apk, at the bucket's width) one
    add_exact_f1; and with each canon_reduce a canonical launch (1,084 /
    1,123 launches at buckets 128 / 1024)."""
    return _with_chains(REFERENCE_PER_VERIFY[bucket],
                        {"inv_w4": 3, "inv_bin": 1, "ratio_chain": 1}, exact_adds=1)
# launches on slice 4's paths: 64-bit G1 and G2 ladders (the G2 one with
# the static |u| = 0xd201000000010000 on its chain, popcount 6) at bucket
# 1024; the unfused doubling of a 128-lane Miller loop (63 iterations); the
# microbenchmark at the reference's R = 40, beside its lane baseline
PER_LADDERS = {"ladder_step_f1": 64, "ladder_step_f2": 64, "jac_add_f2": 6}
PER_UNFUSED = {"f12sqr": 63, "f12mul_034": 63}
UBENCH_R = 40
PER_UBENCH = {"ubench_mul": 1, "ubench_mul_chain": 1, "norm3": 2, "mul": UBENCH_R}
# the real-size batch: the node's default gossip attestation batch
# (max_gossip_attestation_batch_size), 64 committees of 16 validators, each
# committee signing its own message
COMMITTEES, COMMITTEE_SIZE = 64, 16
BLS_CACHE = REPO / "lighthouse_tpu_torch" / "build" / "bls_gossip_1024.cache.pkl"


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


# ------------------------------------------------------------ work counts
# int32 operations per lane element, counted from the bodies (ops/lane/fp.py,
# jacobian.py, tower.py, pairing.py): a carry pass is 5 ops a limb (shift,
# mask, carry add and the topfold multiply-add), an open pass 3; a
# multiply-add is 2; a lazy add, subtract or small multiple of one Fp is W.


def _ops_counts():
    from lighthouse_tpu_torch.ops.lane import fp

    W, sched = fp.W, fp._SCHED

    def passes(site, width):
        per = 3 if site in fp._OPEN_SITES else 5
        return sched[site] * width * per

    def fold(n):
        return (n - fp.FOLD_AT) * W * 2 + fp.FOLD_AT

    core = (W * W * 2 + passes("mul.wide", fp.CONVW) + fold(fp.CONVW)
            + passes("mul.fold37", 37) + fold(37) + passes("mul.fold36", W)
            + fold(W) + passes("mul.fold35", W))
    mul = passes("mul.entry_a", W) + passes("mul.entry_b", W) + core
    sqr = passes("sqr.entry", W) + core
    rl = (passes("rl.entry", W) + fold(W) + passes("rl.fold_a", W) + fold(W)
          + passes("rl.fold_b", W))
    canon = passes("canon.entry", W) + sum(
        fold(W) + passes(s, W)
        for s in ("canon.fold_a", "canon.fold_b", "canon.fold_c", "canon.fold_d")
    )
    # canonical: canon_reduce, + KP, 8 ripples of 37 limbs (add, shift,
    # mask), the ladder's 7 subtracts and selects of 37
    ladder = 37 + 8 * 37 * 3 + 7 * 37 * 2
    lazy = W
    dbl = 5 * sqr + 2 * mul + 3 * rl + 14 * lazy
    add = 5 * sqr + 11 * mul + 4 * rl + 16 * lazy + 3 * W + 2 * W  # + selects, Z tests
    # the exact add: the add, the doubling, H and R (a lazy subtract each),
    # their canonical() and zero tests, the second select
    exact = add + dbl + 2 * (lazy + canon + ladder + W) + 3 * W
    f2sqr = 2 * mul + 3 * lazy
    f2mul = 3 * mul + 2 * rl + 5 * lazy
    dbl_f2 = 5 * f2sqr + 2 * f2mul + 6 * rl + 28 * lazy
    add_f2 = 5 * f2sqr + 11 * f2mul + 8 * rl + 32 * lazy + 6 * W + 4 * W
    f6mul = 6 * f2mul + 6 * rl + 34 * lazy
    f12mul = 3 * f6mul + 32 * lazy
    chains = _chain_launches()
    ratio = chains["ratio_chain"]
    f12sqr = 2 * f6mul + 34 * lazy
    m034 = 13 * f2mul + 60 * lazy
    dbl_step = 6 * f2sqr + 5 * f2mul + 4 * mul + 8 * rl + 34 * lazy
    add_step = 4 * f2sqr + 10 * f2mul + 4 * mul + 8 * rl + 30 * lazy
    # the microbenchmark's product: 3 carry passes at every site
    ub_round = (W * W * 2 + 15 * fp.CONVW + fold(fp.CONVW) + 15 * 37 + fold(37)
                + 15 * W + fold(W) + 15 * W)
    ub_entry = 2 * 15 * W
    return {
        "mul": mul, "sqr": sqr, "canon_reduce": canon, "canonical": canon + ladder,
        "jac_dbl_f1": dbl,
        "jac_add_f1": add, "add_exact_f1": exact, "reduce_light": rl, "f2mul": f2mul, "f2sqr": f2sqr,
        "f6mul": f6mul, "f12mul": f12mul,
        "miller_dbl_iter": dbl_step + f12sqr + m034,
        "miller_add_iter": add_step + m034,
        "cyc_sqr": 9 * f2sqr + 12 * rl + 68 * lazy,
        "jac_dbl_f2": dbl_f2,
        "jac_add_f2": add_f2,
        # 2 doublings, one add, the 3-way and the digit-0 selects
        "g1_win_step": 2 * dbl + add + 3 * W * 3,
        "g2_win_step": 2 * dbl_f2 + add_f2 + 6 * W * 3,
        "norm3": passes("norm3.kernel", W),
        "f12sqr": f12sqr,
        "f12mul_034": m034,
        # the doubling and the 3-coordinate select (the add: _work_ops)
        "ladder_step_f1": dbl + 3 * W,
        "ladder_step_f2": dbl_f2 + 3 * W * 2,
        "ubench_mul": ub_entry + ub_round,
        # the inversions: their chains' squares and products (inv_w4's
        # table stacks 13 products into 3 calls)
        "inv_w4": chains["inv_w4"]["sqr"] * sqr + (chains["inv_w4"]["mul"] + 10) * mul,
        "inv_bin": (chains["inv_bin"]["sqr"] - 1) * sqr + chains["inv_bin"]["mul"] * mul,
        # the ratio chain: its f2sqr and f2mul calls (the table's stacked
        # f2mul 9 of them: 1,369 products, 402 reduce_light) and the
        # table's 3 conjugates
        "ratio_chain": ratio["f2sqr"] * f2sqr + (ratio["f2mul"] + 8) * f2mul + 3 * lazy,
        "ubench_entry": ub_entry,
        "ubench_round": ub_round,
    }


def _work_ops(name: str, args) -> float:
    """int32 operations per lane element of one call (the chain's depend
    on its R, its third argument; a ladder step's on its bit row, its
    seventh: the add only where the bit is set, the share of lane
    elements that need it)."""
    from lighthouse_tpu_torch.ops.lane import coop

    c = _ops_counts()
    if name == "ubench_mul_chain":
        return c["ubench_entry"] + int(args[2]) * c["ubench_round"]
    if name in coop.LADDERS:  # its programs: the add's, then the doubling's
        share = float((args[6] != 0).double().mean())
        return c[name] + share * c[coop.LADDERS[name][0][0]]
    return c[name]


def bound_ms(name: str, args, outs) -> tuple:
    """The least time for one call: this call's bytes (each input read
    once, each output written once, at their own sizes) over the memory
    rate, against its int32 operations over the peak rate."""
    n_bytes = sum(a.numel() * a.element_size() for a in (*args, *outs)
                  if isinstance(a, torch.Tensor))
    lanes = outs[0].numel() // (outs[0].shape[-2] * _rows(name))
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = _work_ops(name, args) * lanes / PEAK_INT32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def _rows(name: str) -> int:
    """Fp rows per lane element of the kernel's first output."""
    from lighthouse_tpu_torch.ops.lane import kernels

    entry = kernels.ENTRIES.get(_op(name).symbol)
    if entry is None:  # the microbenchmark: one Fp element per lane
        return 1
    return int(np.prod(entry[2][0], dtype=np.int64))


def _op(name: str):
    from lighthouse_tpu_torch.ops import epoch
    from lighthouse_tpu_torch.ops.lane import chains, fp, htc, jacobian as J, pairing as OP, tower
    from lighthouse_tpu_torch.ops.lane import sha256
    from lighthouse_tpu_torch.tools import ubench_mul as U

    return {
        "mul": fp.mul, "sqr": fp.sqr, "canon_reduce": fp.canon_reduce,
        "canonical": fp.canonical_op,
        "jac_dbl_f1": J._dbl_f1, "jac_add_f1": J._add_f1, "add_exact_f1": J._add_exact_f1,
        "jac_dbl_f2": J._dbl_f2, "jac_add_f2": J._add_f2,
        "g1_win_step": chains._win_step["fp"], "g2_win_step": chains._win_step["fp2"],
        "reduce_light": fp.reduce_light, "f2mul": tower.f2mul, "f2sqr": tower.f2sqr,
        "f6mul": tower.f6mul, "f12mul": tower.f12mul,
        "miller_dbl_iter": OP._dbl_iter, "miller_add_iter": OP._add_iter,
        "cyc_sqr": OP.cyclotomic_sqr,
        "norm3": fp.norm3, "f12sqr": tower.f12sqr, "f12mul_034": tower.f12mul_034,
        "ladder_step_f1": J._ladder_step_f1, "ladder_step_f2": J._ladder_step_f2,
        "ubench_mul": U.mul, "ubench_mul_chain": U.mul_chain,
        "inv_w4": chains.inv_w4, "inv_bin": fp.inv_bin, "ratio_chain": htc.ratio_chain_op,
        "sha256_pairs": sha256.digest_pairs, "epoch_updates": epoch.updates,
    }[name]


# ---------------------------------------------------------------- phases


def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def _short_name(mangled: str) -> str:
    """The last name of an Itanium-mangled (nested) function name."""
    if not mangled.startswith("_Z"):
        return mangled
    s = mangled[2:].lstrip("N")
    names = []
    while s[:1].isdigit():
        n = re.match(r"\d+", s).group()
        names.append(s[len(n) : len(n) + int(n)])
        s = s[len(n) + int(n) :]
    return names[-1] if names else mangled


def phase_build() -> None:
    from lighthouse_tpu_torch.ops.lane import coop, kernels

    t0 = time.perf_counter()
    kernels.libs()
    info = kernels.BUILD_INFO
    say("build", seconds=f"{time.perf_counter() - t0:.1f}",
        nvcc_seconds=f"{info.get('seconds', 0.0):.1f}",
        built=",".join(info.get("built", [])) or "cached")
    # ptxas -v: registers, stack frame and spill bytes of each function;
    # the kernels' (k_<name>) kept in PTXAS for the `kernels` line
    for lib, log in sorted(info.get("logs", {}).items()):
        fn = None
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w]+)", line)
            if m:
                fn = _short_name(m.group(1))
                continue
            if fn and ("registers" in line or "spill" in line):
                print(f"  ptxas {lib} {fn}: {line.split(':', 1)[-1].strip()}", flush=True)
                if fn.startswith("k_"):
                    row = PTXAS.setdefault(fn[2:], {})
                    for key, pat in _PTXAS_FIELDS.items():
                        if (m := re.search(pat, line)):
                            row[key] = int(m.group(1))
    # the cooperative kernels' dynamic shared memory, as their libraries
    # launch them, against their programs' layout (coop.stats)
    for name, lib in COOP_LIBS.items():
        st = coop.kernel_stats(name)
        LAUNCH_SMEM[name] = getattr(kernels.libs()[lib], f"lh_{lib}_launch_smem")(coop.slot(name))
        if LAUNCH_SMEM[name] != st["smem_bytes"]:
            raise AssertionError(f"{name} launches with {LAUNCH_SMEM[name]} B of shared "
                                 f"memory, its programs lay out {st['smem_bytes']} B")
        say("build", kernel=name, ptxas=json.dumps(PTXAS[name], separators=(",", ":")),
            launch_smem=LAUNCH_SMEM[name], coop=json.dumps(st, separators=(",", ":")))


def _inputs(rng, shape, kind, combos=None):
    """Seeded lazy operands inside the certified intervals. Points: Z = 0
    (structural infinity) on patterned lanes; lanes 0.. take `combos`
    (digit, P1 at infinity, P2 at infinity), by default WIN_COMBOS where
    S holds them all; P1 is the first point, P2 the second or every table
    entry. The exact add's: the add's, with lanes 0.. planted with
    `combos`, cases of EXACT_CASES (by default all of them), on every
    element of the stack."""
    from lighthouse_tpu_torch.crypto.bls.params import P
    from lighthouse_tpu_torch.ops.lane import fp

    S = shape[-1]
    k = int(np.prod(shape[:-2]))

    def canon():
        ints = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(k * S)]
        return fp.pack(ints).reshape(36, k, S).transpose(1, 0, 2).reshape(shape)

    def lazy3():  # a sum of three standard elements, signs mixed
        return canon() + canon() - canon()

    dev = DEVICE
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)  # noqa: E731
    if kind == "mul":
        return [t(lazy3()), t(canon())]
    if kind in ("sqr", "reduce_light"):  # reduce_light: hash-to-G2's lazy sums
        return [t(lazy3())]
    if kind in ("canon_reduce", "canonical"):  # eq_zero's operand: a difference of products
        return [t(canon() - canon())]
    if kind in CHAIN_KERNELS:  # the norm of an Fp2 (a sum of two products); lane 0 zero
        a = t(canon() + canon())
        a[..., 0] = 0
        return [a]
    if kind == "ratio_chain":  # an Fp2 (f2mul's standard output); lane 0 zero
        a = t(canon())
        a[..., 0] = 0
        return [a]
    if kind == "add_exact_f1":  # the add's operands, the planted lanes first
        args = _inputs(rng, shape, "jac_add_f1", combos=[])
        for i, case in enumerate(EXACT_CASES if combos is None else combos):
            for arg, v in zip(args, _exact_case(rng, case), strict=True):
                arg[..., i] = torch.from_numpy(fp.pack([v])[:, 0]).to(dev)
        return args
    lanes = torch.arange(S, device=dev)
    if combos is None:
        combos = WIN_COMBOS if S >= len(WIN_COMBOS) else []
    n = len(combos)
    head = torch.tensor([c[1:] for c in combos], dtype=torch.bool, device=dev).reshape(n, 2)

    def inf(mask, col):  # the pattern's lanes, lanes 0..n-1 the combos'
        mask[:n] = head[:, col]
        return mask

    pts = [t(canon()), t(lazy3()), t(canon())]
    pts[2][..., inf(lanes % 7 == 3, 0)] = 0
    if kind.startswith("jac_dbl"):
        return pts
    other = [t(canon()), t(canon()), t(lazy3())]
    other[2][..., inf((lanes % 5 == 1) | (lanes % 7 == 3), 1)] = 0  # both on some lanes
    if kind.startswith("jac_add"):
        return pts + other
    # a window step: acc (pts), the table T1, T2, T3, and a digit per lane
    table = [[t(canon()), t(canon()), t(canon())] for _ in range(3)]
    for k, entry in enumerate(table):
        entry[2][..., inf(lanes % 11 == 5 if k == 0 else lanes < 0, 1)] = 0
    dig = t(rng.integers(0, 4, size=(*shape[: -2 - (kind == "g2_win_step")], 1, S)))
    dig[..., :n] = torch.tensor([c[0] for c in combos], dtype=torch.int32, device=dev)
    return pts + table[0] + table[1] + table[2] + [dig]


def _exact_case(rng, case: str) -> tuple:
    """The Jacobian (X1, Y1, Z1, X2, Y2, Z2), ints mod p, of planted case
    `case` of EXACT_CASES: P and Q seeded multiples of the generator, P1 =
    P under a seeded Z, P2 under Z2 = l Z1 (or Z2 = Z1); infinity: Z = 0
    under a point's X and Y."""
    from lighthouse_tpu_torch.crypto.bls import curve as C
    from lighthouse_tpu_torch.crypto.bls.params import P, R

    def scalar():
        return int.from_bytes(rng.bytes(32), "big") % R or 1

    def unit():
        return int.from_bytes(rng.bytes(48), "big") % (P - 1) + 1

    def jac(pt, z):
        return (pt[0] * z * z % P, pt[1] * z * z * z % P, z)

    p, q = C.g1_mul(C.G1_GEN, scalar()), C.g1_mul(C.G1_GEN, scalar())
    z, lam = unit(), unit()
    p1 = jac(p, z)
    p2 = {"dbl": jac(p, z), "dbl_rescaled": jac(p, z * lam % P),
          "neg": jac(C.g1_neg(p), z), "neg_rescaled": jac(C.g1_neg(p), z * lam % P)
          }.get(case, jac(q, lam))
    if case in ("inf_p1", "inf_both"):
        p1 = (*p1[:2], 0)
    if case in ("inf_p2", "inf_both"):
        p2 = (*p2[:2], 0)
    return (*p1, *p2)


def exact_branches(args) -> dict:
    """How many lane elements of the exact add's operands take each of its
    five cases (EXACT_BRANCHES), from its plain pieces on their device."""
    from lighthouse_tpu_torch.ops.lane import fp, jacobian as J

    c = fp.consts(args[0].device)
    out = J._add_exact_core_f1(c["folds"], c["topf"], *args)
    p1_inf, p2_inf, h_zero, r_zero = J._add_exact_flags(
        c["folds"], c["topf"], args[2], args[5], out[6], out[7])
    neither = ~(p1_inf | p2_inf)
    takes = (neither & h_zero & r_zero, neither & h_zero & ~r_zero, p1_inf,
             ~p1_inf & p2_inf, neither & ~h_zero)
    return {b: int(m.sum()) for b, m in zip(EXACT_BRANCHES, takes, strict=True)}


# slice 4's seeded holds: the phase-3 shapes, and 1 and 2 lanes
SLICE4_SHAPES = SHAPES + [(36, 1), (36, 2)]
SLICE4_COMP = {"norm3": (), "f12sqr": (2, 3, 2), "f12mul_034": (2, 3, 2),
               "ladder_step_f1": (), "ladder_step_f2": (2,),
               "ubench_mul": (), "ubench_mul_chain": ()}


def _slice4_inputs(rng, shape, kind, bits="mixed", combos=()):
    """Seeded operands of slice 4's kernels over the lanes and stack of
    `shape` [*lead, 36, S]: lazy sums inside the entry contracts, infinity
    lanes on both sides of a ladder step, its bit row all 0, all 1 or
    mixed, lanes 0.. planted with `combos` (bit, accumulator at infinity,
    addend at infinity) on every element of the stack; the chain at R =
    3."""
    from lighthouse_tpu_torch.crypto.bls.params import P
    from lighthouse_tpu_torch.ops.lane import fp

    *lead, _, S = shape
    full = (*lead, *SLICE4_COMP[kind], 36, S)

    def canon(shp=full):
        k = int(np.prod(shp[:-2]))
        ints = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(k * S)]
        return fp.pack(ints).reshape(36, k, S).transpose(1, 0, 2).reshape(shp)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(DEVICE)

    def lazy3():
        return canon() + canon() - canon()

    if kind == "norm3":  # a 12-term add chain, the certified depth
        return [t(sum(canon() for _ in range(12)))]
    if kind == "f12sqr":
        return [t(lazy3())]
    if kind == "f12mul_034":
        f2 = (*lead, 2, 36, S)
        return [t(lazy3()), t(canon(f2)), t(canon(f2)), t(canon(f2))]
    if kind.startswith("ubench"):
        return [t(lazy3()), t(canon())] + ([3] if kind.endswith("chain") else [])
    lanes = torch.arange(S, device=DEVICE)
    free = lanes >= len(combos)          # the lanes the pattern takes
    acc = [t(canon()), t(lazy3()), t(canon())]
    addend = [t(canon()), t(canon()), t(lazy3())]
    acc[2][..., (lanes % 7 == 3) & free] = 0      # structural infinity (Z = 0) lanes
    addend[2][..., (lanes % 5 == 1) & free] = 0
    addend[2][..., (lanes % 7 == 3) & free] = 0   # both at infinity on some lanes
    row = {"0": np.zeros, "1": np.ones}.get(bits)
    bit = t(row((*lead, 1, S)) if row else rng.integers(0, 2, size=(*lead, 1, S)))
    for i, (b, a, e) in enumerate(combos):
        bit[..., i] = b
        if a:
            acc[2][..., i] = 0
        if e:
            addend[2][..., i] = 0
    return acc + addend + [bit]


def _slice4_holds(rng, out: dict) -> None:
    """Slice 4's six kernels (seven CUDA kernels: the microbenchmark is
    two) against their plain bodies on seeded operands at SLICE4_SHAPES,
    every ladder bit row, timed at S=4096 (mixed bits). The cooperative
    ones also at their widths (the ladder steps at S=1024 on every bit
    row, f12sqr and f12mul_034 at F12_S), in device ms and bound there
    (the ladder steps with mixed bits); the ladder steps also at S=1 and 2
    on every LADDER_COMBOS entry (a hold per lane or pair) and, with every
    bit set (the add on every lane element, the most work), in device ms
    and bound at S=1, 1024 and 4096 (keys `_bits1`)."""
    for name in SLICE4_KERNELS:
        ladder, coop = name.startswith("ladder"), name in REDESIGNED
        widths = F12_S if name in F12_KERNELS else REDESIGNED_S
        wide = [(36, S) for S in widths if coop and (36, S) not in SLICE4_SHAPES]
        max_err = 0
        for shape in SLICE4_SHAPES + wide:
            for bits in (("0", "1", "mixed") if ladder else ("mixed",)):
                args = _slice4_inputs(rng, shape, name, bits)
                max_err = max(max_err, _hold(name, args, f"{shape} bits={bits}"))
            if shape == SHAPES[0]:
                if name == "ubench_mul_chain":  # timed at the reference's R
                    args = args[:2] + [UBENCH_R]
                timing, main = _time(name, args), args
        for S in ((1, 2) if ladder else ()):
            for i in range(0, len(LADDER_COMBOS), S):
                args = _slice4_inputs(rng, (2, 36, S), name, combos=LADDER_COMBOS[i : i + S])
                max_err = max(max_err, _hold(name, args, f"S={S} {LADDER_COMBOS[i : i + S]}"))
        if coop:
            timing.update(_widths_ms(name, main, widths))
        if ladder:
            ones = [*main[:-1], torch.ones_like(main[-1])]
            timing.update({k + "_bits1": v
                           for k, v in _widths_ms(name, ones, (1, 1024, 4096)).items()
                           if k.startswith(("ms_S", "bound_ms_S"))})
        out[name] = dict(max_abs_err=max_err, **timing)
        say("kernel", name=name, equal="yes", tolerance="exact(torch.equal)",
            shapes="S=4096,2x128,S=4097,S=1,S=2" + "".join(f",S={sh[-1]}" for sh in wide),
            operands="seeded(infinity lanes, bit rows 0/1/mixed"
            + (", every combination at S=1,2)" if coop else ")") if ladder else "seeded",
            **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in timing.items()})


def _chain_holds(rng, out: dict) -> None:
    """The inversions against their plain bodies on seeded operands at
    SHAPES and CHAIN_S, timed at S=4096 and in device ms and bound at
    REDESIGNED_S."""
    for name in CHAIN_KERNELS:
        max_err = 0
        for shape in SHAPES + [(36, S) for S in CHAIN_S]:
            args = _inputs(rng, shape, name)
            max_err = max(max_err, _hold(name, args, str(shape)))
            if shape == SHAPES[0]:
                timing, main = _time(name, args, plain_reps=2), args
        timing.update(_widths_ms(name, main))
        out[name] = dict(max_abs_err=max_err, **timing)
        say("kernel", name=name, equal="yes", tolerance="exact(torch.equal)",
            shapes="S=4096,2x128,S=4097,S=1,S=2,S=1024", operands="seeded(2-unit, lane 0 zero)",
            **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in timing.items()})


def _canonical_edges():
    """canonical()'s edge operands [36, 7], one a lane: 0, p, -p, p - 1
    and 2p as raw limbs, and a top limb alone (limb 35 = -39153, 46461)
    that puts the ladder's offset value v + KP (v: canon_reduce's output)
    at the two ends of its window (0, p * 2^7): 0.0006 p, where no round
    subtracts, and 0.93 p * 2^7, where all 7 do (tests/test_torch_fp.py
    holds them on the CPU and checks both offsets)."""
    from lighthouse_tpu_torch.crypto.bls.params import P
    from lighthouse_tpu_torch.ops import fp as base

    cols = [np.zeros(36, np.int32), base._limbs_raw(P, 36), -base._limbs_raw(P, 36),
            base.to_limbs(P - 1), base._limbs_raw(2 * P, 36)]
    for top in (-39153, 46461):
        col = np.zeros(36, np.int32)
        col[-1] = top
        cols.append(col)
    return np.stack(cols, axis=1)


def _canonical_chains():
    """canonical()'s long-chain operands [36, 23], one a lane: for k = 0
    .. 6, three lanes whose ladder offset value v + KP (v: canon_reduce's
    output) is p * 2^k - 1, p * 2^k and p * 2^k + 1, where round k's
    difference has every limb 0 but the lowest, so its borrow (or none)
    runs through all 37 limbs; then a lane of limbs all MASK and one all
    -MASK. A chain lane is u with limb 35 = 0, which canon_reduce's first
    two folds leave as it is; its two open passes carry a = u34 >> B and
    then b into limb 35, and the folds take off (a + b)(2^385 - F), F =
    2^385 mod p (FOLDS column 40). So u's value is the target less KP
    plus n (2^385 - F), for the n with a + b = n: limbs 0-32 the digits,
    33 and 34 the rest (tests/test_torch_fp.py checks every offset)."""
    from lighthouse_tpu_torch.crypto.bls.params import P
    from lighthouse_tpu_torch.ops import fp as base
    from lighthouse_tpu_torch.ops.lane import fp

    B, MASK = fp.B, fp.MASK
    f40 = [int(v) for v in fp.FOLDS_NP[:, 40]]
    off = (1 << 385) - sum(v << (B * i) for i, v in enumerate(f40))

    def lane(target):
        for n in sorted(range(-6000, 6000), key=abs):
            value = target - base._KP + n * off
            u34 = value >> 374
            u33 = (value >> 363) & MASK
            if (u34 >> B) + (((u34 & MASK) + f40[34] * (u34 >> B)) >> B) == n:
                col = np.zeros(36, np.int32)
                col[:33] = [(value >> (B * i)) & MASK for i in range(33)]
                col[33], col[34] = u33, u34
                return col
        raise ValueError(f"no operand lands on {target}")

    cols = [lane((P << k) + d) for k in range(7) for d in (-1, 0, 1)]
    cols += [np.full(36, MASK, np.int32), np.full(36, -MASK, np.int32)]
    return np.stack(cols, axis=1)


def _shape(width) -> tuple:
    """A width of CANON_S or RL_S as an operand shape: S -> [36, S], a
    stack (K, S) -> [K, 36, S]."""
    return (width[0], 36, width[1]) if isinstance(width, tuple) else (36, width)


def _width_label(width) -> str:
    return _label(width) if isinstance(width, tuple) else f"S={width}"


def _canonical_holds(rng, out: dict) -> None:
    """canonical against its plain body on seeded differences of products
    at SHAPES and CANON_S and on its edge and long-chain operands (whose
    limbs must be their values mod p), timed at S=4096 and in device ms
    and bound at CANON_S, with the latency floor of its chain."""
    from lighthouse_tpu_torch.ops.lane import fp

    name = "canonical"
    max_err = 0
    for shape in SHAPES + [_shape(w) for w in CANON_S]:
        args = _inputs(rng, shape, name)
        max_err = max(max_err, _hold(name, args, str(shape)))
        if shape == SHAPES[0]:
            timing, main = _time(name, args), args
    for label, cols in (("edges", _canonical_edges()), ("chains", _canonical_chains())):
        x = torch.from_numpy(cols).to(DEVICE)
        max_err = max(max_err, _hold(name, [x], label))
        if not torch.equal(fp.canonical(x).cpu(), torch.from_numpy(fp.pack(fp.unpack(x)))):
            raise AssertionError(f"canonical on the {label}: limbs are not the values mod p")
    timing.update(_widths_ms(name, main, CANON_S))
    out[name] = dict(max_abs_err=max_err, **timing)
    say("kernel", name=name, equal="yes", tolerance="exact(torch.equal)",
        shapes="S=4096,2x128,S=4097," + ",".join(map(_width_label, CANON_S)) + ",edges,chains",
        operands="seeded(differences of products); edges(0,p,-p,p-1,2p,window ends); "
                 "chains(offset p*2^k-1,p*2^k,p*2^k+1 for k=0..6; limbs all MASK, all -MASK)",
        **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in timing.items()})


def _reduce_light_holds(rng, out: dict) -> None:
    """reduce_light against its plain body on seeded lazy sums at RL_S, in
    device ms and bound there with the latency floor of its chain (its
    recorded holds and its time at S=4096 come with the pairing kernels')."""
    name = "reduce_light"
    max_err = 0
    for w in RL_S:
        args = _inputs(rng, _shape(w), name)
        max_err = max(max_err, _hold(name, args, str(_shape(w))))
        if w == RL_S[-1]:
            main = args
    timing = _widths_ms(name, main, RL_S)
    out[name] = dict(max_abs_err=max_err, **timing)
    say("kernel", name=name, equal="yes", tolerance="exact(torch.equal)",
        shapes=",".join(map(_width_label, RL_S)),
        operands="seeded(sums of three standard elements)",
        **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in timing.items()})


def _median_ms(fn, reps=15, warm=2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _kernel_ms(name: str, fn, reps: int = 20) -> tuple:
    """One launch's device time, from the profiler's trace of `reps`
    launches (the host's launch overhead excluded). Where the trace holds
    no device time for the kernel, the CUDA-event median of a whole call
    stands in, and the second value says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pat = rf"\bk_{name}\b"
    for _ in range(4):  # a trace now and then holds no device time: three retries
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if re.search(pat, e.key) and _device_time(e) > 0]
        if hits:
            return (sum(_device_time(e) for e in hits) / sum(e.count for e in hits) / 1e3,
                    "profiler")
    return _median_ms(fn), "events"


def _hold(name: str, args, label: str) -> int:
    """The kernel against its plain body on the same operands: torch.equal
    on every output, else raise. Returns the max |difference| (0)."""
    op = _op(name)
    got = op(*args)
    want = op.plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} {label}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{name} {label}: kernel != plain body (max |diff| {err})")
    return err


def _time(name: str, args, plain_reps: int = 5) -> dict:
    op = _op(name)
    outs = op(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    ms, timed_by = _kernel_ms(name, lambda: op(*args))
    call_ms = _median_ms(lambda: op(*args))
    plain_ms = _median_ms(lambda: op.plain(*args), reps=plain_reps, warm=1)
    b_ms, b_by = bound_ms(name, args, outs)
    return dict(ms=ms, timed_by=timed_by, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def _seeded_pairs(n: int, seed: int) -> list:
    """n pairs (P_i, Q_i) of G1 x G2 points from a seed: two seeded
    multiples of the generators, then steps by a seeded point each."""
    from lighthouse_tpu_torch.crypto.bls import curve as C
    from lighthouse_tpu_torch.crypto.bls.params import R

    rng = np.random.default_rng(seed)

    def scalar():
        return int.from_bytes(rng.bytes(32), "big") % R or 1

    p, dp = C.g1_mul(C.G1_GEN, scalar()), C.g1_mul(C.G1_GEN, scalar())
    q, dq = C.g2_mul(C.G2_GEN, scalar()), C.g2_mul(C.G2_GEN, scalar())
    out = []
    for _ in range(n):
        out.append((p, q))
        p, q = C.g1_add(p, dp), C.g2_add(q, dq)
    return out


def _pack_pairs(pairs):
    from lighthouse_tpu_torch.ops.lane import fp, tower

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)

    return (t(fp.pack([p[0] for p, _ in pairs])), t(fp.pack([p[1] for p, _ in pairs])),
            t(tower.f2_pack_many([q[0] for _, q in pairs])),
            t(tower.f2_pack_many([q[1] for _, q in pairs])))


def _record(fn) -> dict:
    """The operands each kernel was called with while fn() ran: per kernel
    and distinct layout (each operand's shape and whether it is a broadcast
    view), the first and the last call's operands, and the number of calls.
    These lie inside the bodies' laziness contracts by construction."""
    from lighthouse_tpu_torch.ops.lane import fp

    rec = {}
    launch = fp.KernelOp.__call__

    def recording(op, *arrays):
        key = tuple((tuple(a.shape), a.is_contiguous()) for a in arrays)
        entry = rec.setdefault(op.name, {}).setdefault(key, {"first": arrays, "calls": 0})
        entry["last"] = arrays
        entry["calls"] += 1
        return launch(op, *arrays)

    fp.KernelOp.__call__ = recording
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        fp.KernelOp.__call__ = launch
    return rec


def _record_operands(n: int) -> dict:
    """`_record` of a real `miller_loop`, `final_exp` and `f12_eq_one` over
    n seeded pairs (the final exponentiation runs lane-wise here, without
    the lane product, so every kernel sees n lanes)."""
    from lighthouse_tpu_torch.ops.lane import pairing as OP, tower

    def run():
        f = OP.miller_loop(*_pack_pairs(_seeded_pairs(n, SEED)))
        tower.f12_eq_one(OP.final_exp(f))

    return _record(run)


def _layout(key) -> str:
    """An operand layout as `3x2x36x4097,1x2x36x4097~` (~: broadcast view)."""
    return ",".join("x".join(map(str, shape)) + ("" if contiguous else "~")
                    for shape, contiguous in key)


def _stack(a, K: int, S: int):
    """A leading stack of K cuts of S lanes of `a` (lanes repeated where
    `a` is narrower than K x S)."""
    if a.shape[-1] < K * S:
        a = a[..., torch.arange(K * S, device=a.device) % a.shape[-1]]
    return torch.stack([a[..., i * S : (i + 1) * S] for i in range(K)])


def _label(width) -> str:
    """A width of the kernels line: S, or a stack `KxS`."""
    return "x".join(map(str, width)) if isinstance(width, tuple) else str(width)


def _widths(full, extra=()) -> dict:
    """A recorded operand set cut to the widths every kernel must take: 1,
    2, its own, and 2 x 128 (a leading stack of 2); and to `extra`, each a
    lane count the record holds (the BLS bucket-1024 width) or a stack (K,
    S)."""
    cuts = {
        "S=1": [a[..., :1] for a in full],
        "S=2": [a[..., :2] for a in full],
        f"S={full[0].shape[-1]}": list(full),
        "2x128": [_stack(a, 2, 128) for a in full],
    }
    for w in extra:
        if isinstance(w, tuple):
            cuts[_label(w)] = [_stack(a, *w) for a in full]
        elif w < full[0].shape[-1]:
            cuts[f"S={w}"] = [a[..., :w] for a in full]
    return cuts


def _sm_clock_mhz() -> int:
    """The card's maximum SM clock (MHz), from nvidia-smi."""
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])


def _msm_width_holds(rng, name: str, branches: dict) -> int:
    """A G1 group kernel against its plain body on seeded operands at the
    MSM's widths below 4,096 (MSM_S), in the lane sum's layout [36, S]: the
    add on each of ADD_COMBOS, the exact add on each of EXACT_CASES (where
    S holds fewer, a hold per S of them), the doubling once a width on the
    default infinity pattern. The exact add's lanes are counted by case
    into `branches`. Returns the max |difference| (0)."""
    err = 0
    cases = {"jac_add_f1": ADD_COMBOS, "add_exact_f1": EXACT_CASES}.get(name)
    for S in MSM_S[:-1]:
        chunks = [cases[i : i + S] for i in range(0, len(cases), S)] if cases else [None]
        for combos in chunks:
            args = _inputs(rng, (36, S), name, combos=combos)
            err = max(err, _hold(name, args, f"S={S} {combos or 'default pattern'}"))
            if name == "add_exact_f1":
                for b, n in exact_branches(args).items():
                    branches[b] += n
    return err


def _widths_ms(name: str, main, widths=REDESIGNED_S) -> dict:
    """A redesigned kernel's device ms (profiler) and bound at each of
    `widths`, on the recorded operands (its call ms: path_call_ms),
    and the latency floor at one lane element at the maximum SM clock: a
    cooperative kernel's programs' stages one after another, each at
    least one product's chain of dependent multiply-adds
    (JOB_CHAIN_CYCLES); canonical's and reduce_light's chains of
    CANON_CHAIN_OPS and RL_CHAIN_OPS dependent operations at 4 cycles
    each."""
    from lighthouse_tpu_torch.ops.lane import coop

    if name in ("canonical", "reduce_light"):
        cycles = {"canonical": CANON_CHAIN_OPS, "reduce_light": RL_CHAIN_OPS}[name] * 4
    else:
        cycles = coop.kernel_stats(name)["stages"] * JOB_CHAIN_CYCLES
        if name == "add_exact_f1":  # then its zero tests, canonical()'s chain
            cycles += CANON_CHAIN_OPS * 4
    out = {"latency_floor_ms_S1": cycles / (_sm_clock_mhz() * 1e3)}
    for w in widths:
        args = [(_stack(a, *w) if isinstance(w, tuple) else a[..., :w]).contiguous()
                for a in main]
        ms, by = _kernel_ms(name, lambda: _op(name)(*args))
        outs = _op(name)(*args)
        key = _label(w)
        out[f"ms_S{key}"] = ms
        out[f"bound_ms_S{key}"] = bound_ms(name, args, outs if isinstance(outs, tuple) else (outs,))[0]
        if by != "profiler":
            out[f"ms_S{key}_timed_by"] = by
    return out


def phase_kernels() -> dict:
    from lighthouse_tpu_torch.crypto.bls import curve as C
    from lighthouse_tpu_torch.crypto.bls.params import G1X, G1Y
    from lighthouse_tpu_torch.crypto.kzg import _msm_host
    from lighthouse_tpu_torch.ops.lane import fp, msm

    rng = np.random.default_rng(SEED)
    out = {}
    branches = dict.fromkeys(EXACT_BRANCHES, 0)
    for name in SEEDED:
        max_err = 0
        for shape in SHAPES:
            args = _inputs(rng, shape, name)
            max_err = max(max_err, _hold(name, args, str(shape)))
            if name == "add_exact_f1":
                for b, n in exact_branches(args).items():
                    branches[b] += n
            if shape == SHAPES[0]:
                timing, main = _time(name, args), args
        if name in MSM_KERNELS:
            max_err = max(max_err, _msm_width_holds(rng, name, branches))
            timing.update(_widths_ms(name, main, MSM_S))
        for w in SEEDED_S.get(name, ()):
            shape = (w[0], 36, w[1]) if isinstance(w, tuple) else (36, w)
            max_err = max(max_err, _hold(name, _inputs(rng, shape, name), str(shape)))
        if name in SEEDED_S:
            timing.update(_widths_ms(name, main, SEEDED_S[name]))
        out[name] = dict(max_abs_err=max_err, **timing)
        say("kernel", name=name, equal="yes", tolerance="exact(torch.equal)",
            shapes="36x4096,2x36x128,36x4097"
            + (",S=" + "|".join(map(str, MSM_S[:-1])) if name in MSM_KERNELS else "")
            + "".join("," + _label(w) for w in SEEDED_S.get(name, ())),
            operands="seeded" + {"jac_add_f1": "(every infinity combination)",
                                 "add_exact_f1": "(planted: " + ",".join(EXACT_CASES) + ")"
                                 }.get(name, ""),
            **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in timing.items()})
    # every case of the exact add's select taken on some lane it was held on
    say("kernel", name="add_exact_f1", lanes_by_branch=json.dumps(branches, separators=(",", ":")))
    if not all(branches.values()):
        raise AssertionError(f"add_exact_f1: a case of its select was never taken: {branches}")

    _slice4_holds(rng, out)
    _chain_holds(rng, out)
    _canonical_holds(rng, out)
    _reduce_light_holds(rng, out)

    # the pairing kernels, on operands recorded from a real run
    free0, _ = torch.cuda.mem_get_info()
    held0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    rec = _record_operands(4097)
    free1, _ = torch.cuda.mem_get_info()
    outside = (free0 - free1) - (torch.cuda.memory_reserved() - held0)
    say("kernel", recorded="miller_loop + final_exp over 4097 seeded pairs",
        seconds=f"{time.perf_counter() - t0:.1f}",
        device_mib_outside_torch_allocator=f"{outside / 2**20:.1f}")
    for name in RECORDED:
        sets = rec[FUSED.get(name, name)]
        extra = ()
        if name in REDESIGNED:
            extra = F2_S[2:] if name in F2_KERNELS else (1024,)
        max_err = max(
            _hold(name, args, f"{label} [{_layout(key)}] {which}")
            for key, entry in sets.items()
            for which in ("first", "last")
            for label, args in _widths(entry[which], extra).items()
        )
        # timed on the layout the path calls most, made contiguous as the
        # path hands it over (a slice of the record would add a copy per call)
        main = max(sets.values(), key=lambda e: e["calls"])["last"]
        row = out.setdefault(name, {"max_abs_err": 0})
        if "ms" not in row:  # not timed on seeded operands
            row.update(_time(name, [a[..., :4096].contiguous() for a in main], plain_reps=3))
        row["max_abs_err"] = max(row["max_abs_err"], max_err)
        if name not in OFF_PATH:
            s_path = PATH_S.get(name, 1)
            path_args = [a[..., :s_path].contiguous() for a in main]
            row.update(path_S=s_path, path_call_ms=_median_ms(lambda: _op(name)(*path_args)))
        if name in F2_KERNELS:  # one element of the recorded stack: [2, W, S]
            row.update(_widths_ms(name, [a.reshape(-1, *a.shape[-3:])[0] for a in main],
                                  F2_S))
        elif name in REDESIGNED and "ms_S1" not in row:
            row.update(_widths_ms(name, main))
        say("kernel", name=name, equal="yes", tolerance="exact(torch.equal)",
            widths=",".join(_widths(main, extra)),
            operands="recorded",
            layouts="|".join(f"{_layout(k)}:{e['calls']}" for k, e in sets.items()),
            **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in row.items()})

    # canonical(): one launch since slice 11, where canon_reduce's launch
    # fed 8 ripples of 37 small torch ops; at the MSM's width, per MSM
    c = out["canonical"]
    # (none an MSM since slice 13: its exact adds test H and R inside
    # add_exact_f1)
    say("glue", canonical_device_ms_S4096=f"{c['ms']:.5f}",
        canonical_call_ms_S4096=f"{c['call_ms']:.5f}", per_msm=PER_MSM.get("canonical", 0),
        per_msm_device_ms=f"{c['ms'] * PER_MSM.get('canonical', 0):.3f}")

    # a small input against the host group law (the port's _msm_host)
    G = (G1X, G1Y)
    pts = [C.g1_mul(G, k) for k in (3, 5, 7)] + [None]
    sc = [0x1234_5678_9ABC_DEF0, 5, 0, 2**254 + 3]
    got = msm.msm_g1(pts, sc, device=DEVICE)
    if got != _msm_host(pts, sc):
        raise AssertionError("msm_g1 on the card disagrees with the host MSM")
    say("kernel", small_msm="equal to host group law", points=4)
    return out


def phase_pairing128() -> None:
    """The Miller kernels at the smallest BLS batch bucket (128 lanes)."""
    from lighthouse_tpu_torch.crypto.bls import curve as C, pairing_fast as PF
    from lighthouse_tpu_torch.ops.lane import fp, pairing as OP, tower

    pairs = _seeded_pairs(128, SEED + 1)
    xP, yP, xQ, yQ = _pack_pairs(pairs)
    torch.cuda.synchronize()
    t = time.perf_counter()
    f = OP.miller_loop(xP, yP, xQ, yQ)
    f = fp.canonical(f)
    torch.cuda.synchronize()
    miller_s = time.perf_counter() - t
    lanes = (0, 1, 63, 127)
    for s in lanes:
        if tower.f12_unpack_one(f[..., s : s + 1]) != PF.miller_loop_fast(*pairs[s]):
            raise AssertionError(f"128-lane miller_loop lane {s} != host miller_loop_fast")

    # 64 couples (P_i, Q_i), (-P_i, Q_i): e(P, Q) e(-P, Q) = 1
    couples = []
    for p, q in pairs[:64]:
        couples += [(p, q), (C.g1_neg(p), q)]
    xP, yP, xQ, yQ = _pack_pairs(couples)
    walls = {}

    def check(label, qx, qy, p_inf=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fs = OP.miller_loop(xP, yP, qx, qy, p_inf=p_inf)
        v = bool(OP.pairing_product_is_one(fs, 128).all())
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t
        return v

    if check("bilinear", xQ, yQ) is not True:
        raise AssertionError("128-lane product over bilinear couples is not 1")
    xQs, yQs = xQ.clone(), yQ.clone()  # lane 5 (-P_2, Q_2) takes Q_3
    xQs[..., 5], yQs[..., 5] = xQ[..., 7], yQ[..., 7]
    if check("one_q_swapped", xQs, yQs) is not False:
        raise AssertionError("128-lane product with one Q swapped is 1")
    p_inf = torch.zeros(128, dtype=torch.bool, device=DEVICE)
    p_inf[[2, 3, 40, 41, 126, 127]] = True  # three whole couples masked
    if check("p_inf_couples", xQ, yQ, p_inf=p_inf) is not True:
        raise AssertionError("128-lane product with masked couples is not 1")
    say("pairing128", miller_lanes=128, host_equal_lanes=",".join(map(str, lanes)),
        miller_plus_canonical_s=f"{miller_s:.3f}",
        **{f"{k}_s": f"{v:.3f}" for k, v in walls.items()},
        verdicts="True,False,True")


def _split_bundle(raw: bytes):
    """BlobsBundle SSZ: container of 3 variable lists (commitments [48B],
    proofs [48B], blobs [131072B]); the split of
    tests/test_external_vectors.py, copied."""
    o1 = int.from_bytes(raw[0:4], "little")
    o2 = int.from_bytes(raw[4:8], "little")
    o3 = int.from_bytes(raw[8:12], "little")
    comms, proofs, blobs = raw[o1:o2], raw[o2:o3], raw[o3:]
    return (
        [comms[i : i + 48] for i in range(0, len(comms), 48)],
        [proofs[i : i + 48] for i in range(0, len(proofs), 48)],
        [blobs[i : i + 131072] for i in range(0, len(blobs), 131072)],
    )


def _device_time(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def device_totals(events) -> dict:
    """Device ms of a profiler trace's entries (`key_averages()` or
    `events()`), each device event counted once: `device_ms` sums the
    device-side entries (device_type CUDA: the kernels and copies
    themselves), not the CPU ops that launched them, whose self device time
    holds their kernels' again; `device_ms_all_entries` sums every entry
    (the count before this split); `kernels_ms` is each of the port's k_*
    kernels', `glue_ms` the device-side rest (torch's own kernels and
    copies)."""
    dev = _device_side(events)
    ours = {}
    for e in dev:
        if (m := re.search(r"\bk_\w+", e.key)):
            ours[m.group()] = ours.get(m.group(), 0.0) + _device_time(e) / 1e3
    total = sum(_device_time(e) for e in dev) / 1e3
    return dict(device_ms=total,
                device_ms_all_entries=sum(_device_time(e) for e in events) / 1e3,
                glue_ms=total - sum(ours.values()), kernels_ms=ours)


def _profiled(fn, want: dict | None = None) -> tuple:
    """The device-side events of one profiled call of fn (after one call
    unprofiled), for `device_totals`. The unprofiled call's launches (the
    counters' difference) must equal `want` where it is given, and the
    trace must hold as many of each k_* kernel: late in this script a
    trace has dropped its first launches (2-3 of the state path's 60), so
    8 small launches open it, only the events that start inside a range
    around the call count, and a trace short of a launch is taken again,
    up to four times. Returns (the events, or None where no try held
    every launch; the tries)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from lighthouse_tpu_torch.ops.lane import fp

    before = dict(fp.LAUNCHES)
    fn()
    torch.cuda.synchronize()
    got = {k: v - before.get(k, 0) for k, v in fp.LAUNCHES.items() if v != before.get(k, 0)}
    if want is not None and got != want:
        raise AssertionError(f"profiled call: launches {got}, expected {want}")
    pad = torch.zeros(1 << 10, device=DEVICE)
    torch.cuda.synchronize()
    for t in range(1, 5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                pad.add_(1)
            torch.cuda.synchronize()
            with record_function("measured_call"):
                fn()
                torch.cuda.synchronize()
        events = prof.events()
        start = next(e for e in events if e.name == "measured_call").time_range.start
        # the range's own annotation shows on the device side too: not work
        mine = [e for e in _device_side(events)
                if e.time_range.start >= start and e.name != "measured_call"]
        held = {k: sum(bool(re.search(rf"\bk_{k}\b", e.key)) for e in mine) for k in got}
        if held == got:
            return mine, t
        say("trace", attempt=t, launches=json.dumps(got, separators=(",", ":")),
            held=json.dumps(held, separators=(",", ":")))
    return None, t


def _device_side(events) -> list:
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def torch_ops(events) -> tuple:
    """The torch ops of a profiler trace (`events()`): its host-side aten::
    entries, all of them, and those no other aten:: op called (the ops the
    program dispatched itself, as a count by dispatch mode on the CPU sees
    them; tools/verify_census.py)."""
    aten = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("aten::")]

    def outer(e):
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("aten::"):
                return False
            p = p.cpu_parent
        return True

    return len(aten), sum(map(outer, aten))


def _short_key(key: str) -> str:
    """A kernel's profiler key without `void`, namespaces and commas (the
    separator of the line it goes into), cut to 64 characters: enough to
    tell torch's elementwise kernels apart by their functor."""
    key = re.sub(r"void |at::native::|\(anonymous namespace\)::|std::", "", key)
    return key.replace(",", ";").replace(" ", "")[:64]


def _device_share(fn, wall_s: float) -> str:
    """Device time of one call, from the profiler's trace (`device_totals`),
    over the same call's wall time measured without the profiler; its
    torch ops (`torch_ops`), the eight largest device-side entries, and the
    device ms of each of the port's kernels. The key averages' device total
    must equal the trace's events' within 0.5 %."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    tot = device_totals(events)
    if tot["device_ms"] <= 0:
        return "not_measured(no device time in the profiler trace)"
    events_ms = device_totals(prof.events())["device_ms"]
    if abs(tot["device_ms"] - events_ms) > 0.005 * events_ms:
        raise AssertionError(f"device ms {tot['device_ms']:.3f} by key, {events_ms:.3f} by event")
    n_ops, n_outer = torch_ops(prof.events())
    top = sorted(_device_side(events), key=lambda e: -_device_time(e))[:8]
    names = ",".join(f"{_short_key(e.key)}:{_device_time(e) / 1e3:.2f}ms" for e in top)
    ours = {k: round(v, 3) for k, v in tot["kernels_ms"].items()}
    return (f"{tot['device_ms'] / 1e3 / wall_s:.4f} device_ms={tot['device_ms']:.2f} "
            f"device_ms_events={events_ms:.2f} "
            f"device_ms_all_entries={tot['device_ms_all_entries']:.2f} "
            f"glue_ms={tot['glue_ms']:.2f} torch_ops={n_ops} torch_ops_outer={n_outer} "
            f"wall_ms={wall_s * 1e3:.1f} top={names} "
            f"kernels_ms={json.dumps(ours, separators=(',', ':'))}")


def phase_e2e() -> dict:
    from lighthouse_tpu_torch.crypto.bls import curve as C, pairing_fast as PF
    from lighthouse_tpu_torch.crypto.bls.params import R
    from lighthouse_tpu_torch.crypto.kzg import TrustedSetup
    from lighthouse_tpu_torch.crypto.kzg.device import (
        device_kzg, pairings_product_is_one_device,
    )
    from lighthouse_tpu_torch.ops.lane import fp

    t0 = time.perf_counter()
    setup = TrustedSetup.mainnet()
    say("e2e", setup="mainnet", points=len(setup.g1_lagrange), load_s=f"{time.perf_counter() - t0:.2f}")
    kzg = device_kzg(setup, device=DEVICE)
    # record the pairs the batch check hands its (device) pairing seam
    seam_pairs = []
    device_seam = kzg._pairing
    kzg._pairing = lambda pairs: (seam_pairs.append(pairs), device_seam(pairs))[1]
    comms, proofs, blobs = _split_bundle(FIXTURE.read_bytes())
    rng = np.random.default_rng(SEED)
    for _ in range(5):  # canonical field elements: one Deneb block holds 6 blobs
        vals = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(4096)]
        blobs.append(b"".join(v.to_bytes(32, "big") for v in vals))

    setup.g1_basis(DEVICE)  # packing the basis is set-up, not an MSM
    torch.cuda.synchronize()
    fp.reset_counts()  # ---- the main path's run starts here
    walls = {"commit": [], "prove": []}
    cs, ps = [], []
    per_msm = None
    for i, blob in enumerate(blobs):
        before = dict(fp.LAUNCHES)
        t = time.perf_counter()
        c = kzg.blob_to_kzg_commitment(blob)
        walls["commit"].append(time.perf_counter() - t)
        if i == 0:
            per_msm = {k: d for k in KERNELS if (d := fp.LAUNCHES[k] - before.get(k, 0))}
        t = time.perf_counter()
        p, _ = kzg.compute_blob_kzg_proof(blob, c)
        walls["prove"].append(time.perf_counter() - t)
        cs.append(c)
        ps.append(p)
        if i == 0:
            if C.g1_compress(c) != comms[0]:
                raise AssertionError("fixture commitment differs from c-kzg's")
            if C.g1_compress(p) != proofs[0]:
                raise AssertionError("fixture proof differs from c-kzg's")
            say("e2e", fixture_commitment="equal to c-kzg bytes", fixture_proof="equal to c-kzg bytes")
    t = time.perf_counter()
    ok = kzg.verify_blob_kzg_proof_batch(blobs, cs, ps)
    verify_s = time.perf_counter() - t
    if ok is not True:
        raise AssertionError(f"batch of {len(blobs)} blobs did not verify")
    batch_pairs = seam_pairs[-1]
    bad = bytearray(blobs[0])
    bad[5000] ^= 1
    t = time.perf_counter()
    ok_bad = kzg.verify_blob_kzg_proof_batch([bytes(bad)] + blobs[1:], cs, ps)
    verify_bad_s = time.perf_counter() - t
    if ok_bad is not False:
        raise AssertionError("a corrupted blob verified")
    # c-kzg's fixture commitment and proof, from their bytes
    fc, fpr = C.g1_decompress(comms[0]), C.g1_decompress(proofs[0])
    t = time.perf_counter()
    ok_one = kzg.verify_blob_kzg_proof(blobs[0], fc, fpr)
    verify_one_s = time.perf_counter() - t
    if ok_one is not True:
        raise AssertionError("c-kzg's fixture blob proof did not verify")
    if kzg.verify_blob_kzg_proof(bytes(bad), fc, fpr) is not False:
        raise AssertionError("c-kzg's fixture proof verified a corrupted blob")
    torch.cuda.synchronize()
    launches = dict(fp.LAUNCHES)  # ---- ... and ends here
    plain_calls = dict(fp.PLAIN_CUDA_CALLS)
    say("e2e", blobs=len(blobs), batch_verify="True", corrupted_verify="False",
        fixture_verify="True", fixture_corrupted_verify="False",
        commit_s=f"{statistics.median(walls['commit']):.3f}",
        prove_s=f"{statistics.median(walls['prove']):.3f}",
        verify_batch_s=f"{verify_s:.3f}", verify_corrupted_s=f"{verify_bad_s:.3f}",
        verify_one_s=f"{verify_one_s:.3f}")
    missing = [k for k in KZG_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the KZG path: {missing}")
    if plain_calls:
        raise AssertionError(f"plain bodies ran on CUDA tensors on the main path: {plain_calls}")
    say("e2e", launches=json.dumps(launches, separators=(",", ":")))
    if per_msm != PER_MSM:
        raise AssertionError(f"launches per 4096-lane MSM {per_msm}, expected {PER_MSM}")
    say("e2e", launches_per_msm=json.dumps(per_msm, separators=(",", ":")))

    # the pairing seam apart, on the batch check's own pairs
    if len(batch_pairs) != 2:
        raise AssertionError(f"the batch check handed {len(batch_pairs)} pairs, expected 2")
    seam = {}
    per_check_want = check_launches()
    for label in ("device", "host", "device", "host"):
        before = dict(fp.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if label == "device":
            v = pairings_product_is_one_device(batch_pairs, device=DEVICE)
            torch.cuda.synchronize()
        else:
            v = PF.pairings_product_is_one_fast(batch_pairs)
        seam.setdefault(label, []).append(time.perf_counter() - t)
        if v is not True:
            raise AssertionError(f"{label} pairing seam gave {v} on the verified batch")
        if label == "device":
            per_check = {k: d for k in KERNELS if (d := fp.LAUNCHES[k] - before.get(k, 0))}
            if per_check != per_check_want:
                raise AssertionError(f"launches per 2-lane pairing check {per_check}, "
                                     f"expected {per_check_want}")
    say("e2e", pairing_seam_pairs=2, verdicts="device=True,host=True",
        device_pairing_s=",".join(f"{s:.4f}" for s in seam["device"]),
        host_pairing_s=",".join(f"{s:.4f}" for s in seam["host"]),
        launches_per_check=json.dumps(per_check, separators=(",", ":")))
    share = _device_share(
        lambda: kzg.blob_to_kzg_commitment(blobs[1]), statistics.median(walls["commit"])
    )
    say("e2e", msm_device_share=share)
    share = _device_share(
        lambda: pairings_product_is_one_device(batch_pairs, device=DEVICE), min(seam["device"])
    )
    say("e2e", pairing_device_share=share)
    return launches


# ---------------------------------------------------------------- BLS


def _make_sets(n: int, same_msg: bool = False) -> list:
    """n single-key sets from seeded keys (tests/test_tpu_backend.py's)."""
    from lighthouse_tpu_torch.crypto.bls.keys import SecretKey, SignatureSet

    sets = []
    for i in range(n):
        sk = SecretKey.from_seed(bytes([i + 1, 7]) * 2)
        msg = b"fixed" if same_msg else b"msg-%d" % i
        sets.append(SignatureSet.single_pubkey(sk.sign(msg), sk.public_key(), msg))
    return sets


def _non_subgroup_point():
    """A point on E2 outside the r-torsion: the first x = (k, 0) whose
    curve equation has a root and fails the subgroup check."""
    from lighthouse_tpu_torch.crypto.bls import curve as C, fields as F

    x = (1, 0)
    while True:
        y = F.f2sqrt(F.f2add(F.f2mul(F.f2sqr(x), x), C._B2))
        if y is not None and not C.g2_subgroup_check((x, y)):
            return (x, y)
        x = (x[0] + 1, 0)


def _gossip_batch() -> list:
    """COMMITTEES x COMMITTEE_SIZE single-key sets, each committee's
    validators signing the committee's own message, keys from seeds. The
    points are cached under lighthouse_tpu_torch/build/ (made in ~30 s of
    host math otherwise)."""
    import pickle

    from lighthouse_tpu_torch.crypto.bls.keys import PublicKey, SecretKey, Signature, SignatureSet

    msgs = [b"attestation-data-committee-%d" % c for c in range(COMMITTEES)]
    if BLS_CACHE.exists():
        rows = pickle.loads(BLS_CACHE.read_bytes())
    else:
        rows = []
        for c, msg in enumerate(msgs):
            for v in range(COMMITTEE_SIZE):
                sk = SecretKey.from_seed(b"validator-%d-%d" % (c, v))
                rows.append((sk.public_key().point, sk.sign(msg).point, msg))
        BLS_CACHE.parent.mkdir(parents=True, exist_ok=True)
        tmp = BLS_CACHE.with_suffix(".tmp")
        tmp.write_bytes(pickle.dumps(rows))
        tmp.replace(BLS_CACHE)
    return [SignatureSet.single_pubkey(Signature(point=sig), PublicKey(point=pk), msg)
            for pk, sig, msg in rows]


def _scalars(rng, n: int) -> list:
    return [int.from_bytes(rng.bytes(8), "big") | 1 for _ in range(n)]


def _seeded_bls_holds(rng, out: dict) -> None:
    """Slice 3's four kernels against their plain bodies on seeded operands
    (infinity lanes, every digit), timed at S=4096; the cooperative ones
    (all four since slice 8) also at S=1024, at S=1 and 2 on every
    WIN_COMBOS entry (an add reads its P1 and P2 infinity), and in device
    ms and bound at REDESIGNED_S."""
    for name in BLS_SEEDED:
        f2 = name in ("jac_dbl_f2", "jac_add_f2", "g2_win_step")
        coop = name in REDESIGNED
        max_err = 0
        for shape in SHAPES + ([(36, 1024)] if coop else []):
            shape = (*shape[:-2], 2, *shape[-2:]) if f2 else shape
            args = _inputs(rng, shape, name)
            max_err = max(max_err, _hold(name, args, str(shape)))
            if shape[-1] == SHAPES[0][-1]:
                timing, main = _time(name, args), args
        for S in ((1, 2) if coop else ()):
            for i in range(0, len(WIN_COMBOS), S):
                args = _inputs(rng, (2, 36, S), name, combos=WIN_COMBOS[i : i + S])
                max_err = max(max_err, _hold(name, args, f"S={S} {WIN_COMBOS[i : i + S]}"))
        if coop:
            timing.update(_widths_ms(name, main))
        out[name] = dict(max_abs_err=max_err, **timing)
        say("bls", kernel=name, equal="yes", tolerance="exact(torch.equal)",
            shapes="S=4096,2x128,S=4097" + (",S=1024,S=1,S=2" if coop else ""),
            operands="seeded(infinity lanes, digits 0-3" + (", every combination)" if coop else ")"),
            **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in timing.items()})


def _ratio_chain_holds(rng, out: dict) -> None:
    """ratio_chain against its plain body on seeded Fp2 operands (lane 0
    zero) at the phase 3 shapes and RATIO_S, timed at S=4096 and in device
    ms and bound at RATIO_S."""
    name = "ratio_chain"
    max_err = 0
    for shape in SHAPES + [(36, S) for S in RATIO_S if S != SHAPES[0][-1]]:
        args = _inputs(rng, (*shape[:-2], 2, *shape[-2:]), name)
        max_err = max(max_err, _hold(name, args, str(shape)))
        if shape == SHAPES[0]:
            timing, main = _time(name, args, plain_reps=2), args
    timing.update(_widths_ms(name, main, RATIO_S))
    out[name] = dict(max_abs_err=max_err, **timing)
    say("bls", kernel=name, equal="yes", tolerance="exact(torch.equal)",
        shapes="S=4096,2x128,S=4097," + ",".join(f"S={S}" for S in RATIO_S[:-1]),
        operands="seeded(standard Fp2, lane 0 zero)",
        **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in timing.items()})


def _verify_matrix(rng, card: str) -> dict:
    """tests/test_tpu_backend.py's cases through the front with
    backend="cuda", each against backend="cpu" on the same scalars. Returns
    the launches of the first (a valid batch of 5, bucket 128)."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls.keys import SecretKey, Signature, SignatureSet
    from lighthouse_tpu_torch.ops.lane import fp

    def both(label, sets, want):
        rs = _scalars(rng, len(sets))
        got = bls.verify_signature_sets(sets, backend="cuda", rand_scalars=rs)
        oracle = bls.verify_signature_sets(sets, backend="cpu", rand_scalars=rs)
        if got is not want or oracle is not want:
            raise AssertionError(f"{label}: cuda {got}, cpu {oracle}, expected {want}")
        return got

    verdicts = {}
    before = dict(fp.LAUNCHES)
    verdicts["valid_5"] = both("valid batch of 5", _make_sets(5), True)
    per_128 = {k: d for k in KERNELS if (d := fp.LAUNCHES[k] - before.get(k, 0))}
    sets = _make_sets(5)
    evil = SecretKey.from_seed(b"evil-key")
    sets[2] = SignatureSet.single_pubkey(
        evil.sign(b"wrong message"), sets[2].signing_keys[0], sets[2].message)
    verdicts["poisoned"] = both("one bad signature", sets, False)
    sks = [SecretKey.from_seed(bytes([i, 9, 9])) for i in range(1, 4)]
    msg = b"aggregate me"
    pks = [sk.public_key() for sk in sks]
    agg = bls.aggregate_signatures([sk.sign(msg) for sk in sks])
    verdicts["multi_pubkey"] = both(
        "multi-pubkey set", [SignatureSet.multiple_pubkeys(agg, pks, msg)] + _make_sets(2), True)
    agg_bad = bls.aggregate_signatures([sk.sign(msg) for sk in sks[:2]])
    verdicts["signer_missing"] = both(
        "aggregate missing a signer", [SignatureSet.multiple_pubkeys(agg_bad, pks, msg)], False)
    one = _make_sets(1)[0]
    verdicts["empty_input"] = both("empty input", [], False)
    verdicts["no_keys"] = both(
        "set with no keys", [SignatureSet(signature=one.signature, signing_keys=[], message=b"x")],
        False)
    verdicts["infinity_signature"] = both(
        "infinity signature",
        [SignatureSet.single_pubkey(Signature(point=None), one.signing_keys[0], one.message)],
        False)
    for backend in ("cuda", "cpu"):
        try:
            bls.verify_signature_sets([one], backend=backend, rand_scalars=[0])
        except ValueError:
            continue
        raise AssertionError(f"{backend}: a zero batch scalar was not refused")
    verdicts["scalar_out_of_range"] = "ValueError"
    sets = _make_sets(2)
    sets[1] = SignatureSet.single_pubkey(
        Signature(point=_non_subgroup_point()), sets[1].signing_keys[0], sets[1].message)
    verdicts["non_subgroup_signature"] = both("signature outside G2", sets, False)
    sk = SecretKey.from_seed(b"single")
    sig = sk.sign(b"hello")
    for label, m, want in (("single_true", b"hello", True), ("single_false", b"goodbye", False)):
        got = bls.verify(sig, sk.public_key(), m, backend="cuda")
        if got is not want or bls.verify(sig, sk.public_key(), m, backend="cpu") is not want:
            raise AssertionError(f"verify_single {label}: cuda {got}, expected {want}")
        verdicts[label] = got
    say("bls", matrix_bucket=128, card=repr(card),
        verdicts=",".join(f"{k}={v}" for k, v in verdicts.items()), oracle="cpu backend, same scalars")
    return per_128


def phase_bls(card: str) -> tuple:
    """Slice 3's main path, BLS verify_signature_sets on the card."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls.backends import cuda as CB
    from lighthouse_tpu_torch.ops.lane import fp

    rng = np.random.default_rng(SEED + 3)
    out = {}
    _seeded_bls_holds(rng, out)
    _ratio_chain_holds(rng, out)

    # every kernel of a bucket-128 verify, on the operands it met there
    sets5, rs5 = _make_sets(5), _scalars(rng, 5)
    rec = _record(lambda: CB.verify_signature_sets(sets5, rs5, device=DEVICE))
    n_layouts = 0
    for name in sorted(rec) + [k for k, v in FUSED.items() if v in rec]:
        sets = rec[FUSED.get(name, name)]
        max_err = max(
            _hold(name, args, f"bls {label} [{_layout(key)}] {which}")
            for key, entry in sets.items()
            for which in ("first", "last")
            for label, args in _widths(entry[which]).items()
        )
        n_layouts += len(sets)
        # the layout with the most lane work (calls x lanes), as the path
        # hands it over
        main = max(sets.values(), key=lambda e: e["calls"] * e["last"][0].shape[-1])["last"]
        path_args = [a.contiguous() for a in main]
        row = out.setdefault(name, {"max_abs_err": 0})
        row["max_abs_err"] = max(row["max_abs_err"], max_err)
        if name not in OFF_PATH:
            row.update(bls_path_S=main[0].shape[-1],
                       bls_path_call_ms=_median_ms(lambda: _op(name)(*path_args)))
        say("bls", kernel=name, equal="yes", tolerance="exact(torch.equal)",
            widths="S=1,S=2,own,2x128", operands="recorded(bucket-128 verify)",
            layouts="|".join(f"{_layout(k)}:{e['calls']}" for k, e in sets.items()),
            **{k: (f"{row[k]:.5f}" if isinstance(row[k], float) else row[k])
               for k in ("bls_path_S", "bls_path_call_ms") if k in row})
    missing = sorted(set(BLS_KERNELS) - set(rec))
    if missing:
        raise AssertionError(f"kernels a bucket-128 verify did not call: {missing}")
    say("bls", recorded_layouts=n_layouts, kernels=len(rec))

    t0 = time.perf_counter()
    gossip = _gossip_batch()
    say("bls", gossip_sets=len(gossip), committees=COMMITTEES, committee_size=COMMITTEE_SIZE,
        keys_s=f"{time.perf_counter() - t0:.2f}", cache=BLS_CACHE.name)
    # the first validator's signature moved onto the last committee's set
    tampered = list(gossip)
    tampered[-1] = type(gossip[-1])(signature=gossip[0].signature,
                                    signing_keys=gossip[-1].signing_keys,
                                    message=gossip[-1].message)
    rs = _scalars(rng, len(gossip))
    CB.TIMES.clear()
    torch.cuda.synchronize()
    fp.reset_counts()  # ---- the BLS main path's run starts here
    per_128 = _verify_matrix(rng, card)
    walls = []
    for i in range(3):
        before = dict(fp.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ok = bls.verify_signature_sets(gossip, backend="cuda", rand_scalars=rs)
        walls.append(time.perf_counter() - t)
        if ok is not True:
            raise AssertionError("the 1,024-set gossip batch did not verify")
        if i == 0:
            per_1024 = {k: d for k in KERNELS if (d := fp.LAUNCHES[k] - before.get(k, 0))}
    if bls.verify_signature_sets(tampered, backend="cuda", rand_scalars=rs) is not False:
        raise AssertionError("the gossip batch with one signature moved verified")
    torch.cuda.synchronize()
    launches = dict(fp.LAUNCHES)  # ---- ... and ends here
    plain_calls = dict(fp.PLAIN_CUDA_CALLS)
    missing = [k for k in BLS_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the BLS path: {missing}")
    if plain_calls:
        raise AssertionError(f"plain bodies ran on CUDA tensors on the BLS path: {plain_calls}")
    for bucket, got in ((128, per_128), (1024, per_1024)):
        if got != verify_launches(bucket):
            raise AssertionError(f"launches per verify at bucket {bucket} {got}, "
                                 f"expected the census {verify_launches(bucket)}")
        say("bls", bucket=bucket, launches_per_verify=sum(got.values()),
            by_op=json.dumps(got, separators=(",", ":")), census="equal")
    say("bls", launches=json.dumps(launches, separators=(",", ":")))

    times = {}
    for bucket, rec_t in sorted(CB.TIMES.items()):
        host, dev = rec_t["host_pack"], rec_t["device"]
        wall = [h + d for h, d in zip(host, dev)]
        times[bucket] = dict(
            verifies=len(wall), wall_s=statistics.median(wall),
            host_pack_s=statistics.median(host), device_s=statistics.median(dev))
        say("bls", bucket=bucket, card=repr(card), verifies=len(wall),
            wall_s=",".join(f"{w:.4f}" for w in wall),
            host_pack_s=",".join(f"{h:.4f}" for h in host),
            device_s=",".join(f"{d:.4f}" for d in dev))
    wall_1024 = statistics.median(walls)
    say("bls", bucket=1024, card=repr(card), front_wall_s=",".join(f"{w:.4f}" for w in walls),
        sets_per_s=f"{len(gossip) / wall_1024:.1f}")
    share = _device_share(
        lambda: bls.verify_signature_sets(gossip, backend="cuda", rand_scalars=rs), wall_1024)
    say("bls", bucket=1024, card=repr(card), verify_device_share=share)
    return out, launches


def _window(label: str, want: dict, fn, phase: str = "ladders"):
    """Run fn() with the launch counters zeroed just before and read just
    after; the counts must equal `want`, with no plain body on a CUDA
    tensor. Returns (fn's result, wall s)."""
    from lighthouse_tpu_torch.ops.lane import fp

    torch.cuda.synchronize()
    fp.reset_counts()  # ---- the path's run starts here
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got, plain = dict(fp.LAUNCHES), dict(fp.PLAIN_CUDA_CALLS)  # ---- ... and ends here
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    if plain:
        raise AssertionError(f"{label}: plain bodies ran on CUDA tensors: {plain}")
    say(phase, path=label, launches=json.dumps(got, separators=(",", ":")),
        plain_body_calls_on_cuda=0)
    return res, wall


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def _totals(fn, want: dict | None = None) -> dict | None:
    """`device_totals` of one call of fn, every launch held (`_profiled`),
    or None where no trace held them all."""
    events, _ = _profiled(fn, want)
    return device_totals(events) if events is not None else None


def _kernel_share(tot: dict | None, name: str):
    return tot["kernels_ms"].get(f"k_{name}") if tot is not None else None


def _device_fields(device: dict) -> dict:
    """Each run's device ms, and its kernels', for a `say` line."""
    return {**{k: f"{v['device_ms']:.4f}" if v is not None else "not_measured(no whole trace)"
               for k, v in device.items()},
            "kernels_device_ms": json.dumps(
                {k: {n: round(ms, 4) for n, ms in v["kernels_ms"].items()}
                 for k, v in device.items() if v is not None}, separators=(",", ":"))}


def _ladders_1024(card: str, out: dict) -> dict:
    """The per-lane ladders on the 1,024-set gossip batch (bucket 1024),
    beside the windowed chains of the main path on the same lanes."""
    from lighthouse_tpu_torch.crypto.bls.backends import cuda as CB
    from lighthouse_tpu_torch.ops.lane import chains, fp, jacobian as J, tower

    gossip = _gossip_batch()
    rs = _scalars(np.random.default_rng(SEED + 4), len(gossip))
    apk_x, apk_y, sig_x, sig_y, _, _, rbits, _ = CB.to_device(CB.prepare_batch(gossip, rs), DEVICE)
    S = apk_x.shape[-1]
    # the last lane's signature moved onto a point of E2 outside G2
    off = _non_subgroup_point()
    sig_x[..., -1:] = torch.from_numpy(tower.f2_pack(off[0])).to(DEVICE)
    sig_y[..., -1:] = torch.from_numpy(tower.f2_pack(off[1])).to(DEVICE)
    one1 = torch.from_numpy(fp.ONE).to(DEVICE)[:, None].expand(fp.W, S)
    one2 = tower.bcast(tower.consts(DEVICE)["f2_one"], S)
    apk, sig = (apk_x, apk_y, one1), (sig_x, sig_y, one2)
    m_abs = CB._M_ABS

    def ladders():
        r_apk = J.scalar_mul(J.FP1, apk, rbits)
        return r_apk, *J.scalar_mul_with_static(J.FP2, sig, rbits, m_abs)

    (r_apk, dyn, stat), wall = _window("ladders_1024", PER_LADDERS, ladders)

    r_apk_w = chains.scalar_mul_w2(J.FP1, apk, rbits)
    r_sig_w = chains.scalar_mul_w2(J.FP2, sig, rbits)
    stat_ref = J.scalar_mul_static(J.FP2, sig, m_abs)
    if not bool(J.jac_eq(J.FP1, r_apk, r_apk_w).all()):
        raise AssertionError("[r]apk: scalar_mul != scalar_mul_w2 on some lane")
    if not bool(J.jac_eq(J.FP2, dyn, r_sig_w).all()):
        raise AssertionError("[r]S: scalar_mul_with_static != scalar_mul_w2 on some lane")
    for a, b in zip(stat, stat_ref, strict=True):
        if not torch.equal(a, b):
            raise AssertionError("[|u|]S: scalar_mul_with_static's limbs != scalar_mul_static's")
    sub = J.jac_eq(J.FP2, J.psi(sig), J.neg(J.FP2, stat)).tolist()
    if not all(sub[:-1]) or sub[-1]:
        bad = [i for i, v in enumerate(sub[:-1]) if not v]
        raise AssertionError(f"subgroup verdicts: real lanes failing {bad[:8]}, "
                             f"the lane off G2 {'passed' if sub[-1] else 'failed'}")

    # walls at 1024 lanes, each ladder beside its windowed counterpart, in
    # turns (ladder, windowed, windowed, ladder, ...), the median of 4
    runs = {
        "g1_ladder_s": lambda: J.scalar_mul(J.FP1, apk, rbits),
        "g1_windowed_s": lambda: chains.scalar_mul_w2(J.FP1, apk, rbits),
        "g2_ladder_with_static_s": lambda: J.scalar_mul_with_static(J.FP2, sig, rbits, m_abs),
        "g2_windowed_plus_static_s": lambda: (chains.scalar_mul_w2(J.FP2, sig, rbits),
                                              J.scalar_mul_static(J.FP2, sig, m_abs)),
    }
    times = {k: [] for k in runs}
    for rep in range(4):
        for pair in (tuple(runs)[:2], tuple(runs)[2:]):
            for k in (pair if rep % 2 == 0 else pair[::-1]):
                times[k].append(_wall(runs[k]))
    walls = {k: statistics.median(v) for k, v in times.items()}
    # device ms of one run of each, every device event once, every launch
    # held, and the ladder steps' share (all 64 launches)
    pins = {"g1_ladder_s": {"ladder_step_f1": 64},
            "g2_ladder_with_static_s": {k: v for k, v in PER_LADDERS.items()
                                        if k != "ladder_step_f1"}}
    device = {k.removesuffix("_s") + "_device_ms": _totals(fn, pins.get(k))
              for k, fn in runs.items()}
    rows = rbits.to(torch.int32)[:, None, :]
    for name, pt, run in (("ladder_step_f1", apk, "g1_ladder_device_ms"),
                          ("ladder_step_f2", sig, "g2_ladder_with_static_device_ms")):
        out.setdefault(name, {}).update(
            slice4_path_S=S,
            slice4_path_call_ms=_median_ms(lambda: _op(name)(*pt, *pt, rows[0])),
            slice4_path_device_ms=_kernel_share(device[run], name))
    say("ladders", bucket=S, card=repr(card), r_apk="jac_eq scalar_mul_w2 on all lanes",
        r_sig="jac_eq scalar_mul_w2 on all lanes",
        u_sig="torch.equal scalar_mul_static",
        subgroup=f"psi(S)==-[|u|]S on {len(sub) - 1} real lanes, False on the lane off G2",
        counted_run_s=f"{wall:.4f}", **{k: f"{v:.4f}" for k, v in walls.items()},
        **_device_fields(device))
    return walls


def _unfused_doubling(out: dict) -> None:
    """f12mul_034(f12sqr(f), c0, c1, c4) through the two standalone
    kernels on every doubling iteration of a 128-lane Miller loop (phase
    4's pairs), torch.equal to miller_dbl_iter's f; the line coefficients
    from the plain doubling-step body on the same CUDA tensors (the check's
    reference, not the path)."""
    from lighthouse_tpu_torch.ops.lane import fp, pairing as OP, tower

    xP, yP, xQ, yQ = _pack_pairs(_seeded_pairs(128, SEED + 1))
    calls = []
    launch = fp.KernelOp.__call__

    def recording(op, *arrays):
        res = launch(op, *arrays)
        if op.name == "miller_dbl_iter":
            calls.append((arrays, res[0]))
        return res

    fp.KernelOp.__call__ = recording
    try:
        OP.miller_loop(xP, yP, xQ, yQ)
        torch.cuda.synchronize()
    finally:
        fp.KernelOp.__call__ = launch
    c = fp.consts(DEVICE)
    lines = [OP._dbl_step_body(c["folds"], c["topf"], *args[1:])[3:] for args, _ in calls]

    def unfused():
        return [tower.f12mul_034(tower.f12sqr(args[0]), *ln)
                for (args, _), ln in zip(calls, lines, strict=True)]

    fs, wall = _window("unfused_doubling_128", PER_UNFUSED, unfused)
    for i, (f, (_, want)) in enumerate(zip(fs, calls, strict=True)):
        if not torch.equal(f, want):
            raise AssertionError(f"unfused doubling {i}: f12mul_034(f12sqr(f)) != miller_dbl_iter's f")
    # device ms of one run of the 63 unfused doublings and of the 63 fused
    # miller_dbl_iter launches on the same operands, each device event once
    device = {"unfused": _totals(unfused, PER_UNFUSED),
              "fused": _totals(lambda: [OP._dbl_iter(*args) for args, _ in calls],
                               {"miller_dbl_iter": len(calls)})}
    f_mid = calls[len(calls) // 2][0][0].contiguous()
    ln = [a.contiguous() for a in lines[len(lines) // 2]]
    out.setdefault("f12sqr", {}).update(
        slice4_path_S=128, slice4_path_call_ms=_median_ms(lambda: tower.f12sqr(f_mid)),
        slice4_path_device_ms=_kernel_share(device["unfused"], "f12sqr"))
    out.setdefault("f12mul_034", {}).update(
        slice4_path_S=128, slice4_path_call_ms=_median_ms(lambda: tower.f12mul_034(f_mid, *ln)),
        slice4_path_device_ms=_kernel_share(device["unfused"], "f12mul_034"))
    say("ladders", unfused_doubling="torch.equal miller_dbl_iter's f", iterations=len(calls),
        lanes=128, wall_s=f"{wall:.4f}",
        **_device_fields({"unfused_doubling_device_ms": device["unfused"],
                          "fused_dbl_iter_device_ms": device["fused"]}))


def _ubench(card: str, out: dict) -> dict:
    """The microbenchmark at the reference's S and R: one window through
    both kernels and the lane baseline, the products against Python ints,
    the kernels held at full width, then its own timed runs at that S and
    at 1,024 lanes (the widest BLS bucket)."""
    from lighthouse_tpu_torch.crypto.bls.params import P
    from lighthouse_tpu_torch.ops.lane import fp
    from lighthouse_tpu_torch.tools import ubench_mul as U

    S = U.S_DEFAULT
    ints_a, ints_b, A, Bm = U.operands(S, DEVICE)
    (one, chain, lane), _ = _window("ubench", PER_UBENCH, lambda: (
        U.mul(A, Bm), U.mul_chain(A, Bm, UBENCH_R), U.lane_chain(A, Bm, UBENCH_R)))
    want = [a * pow(b, UBENCH_R, P) % P for a, b in zip(ints_a, ints_b)]
    if fp.unpack(one[:, :8]) != [a * b % P for a, b in zip(ints_a, ints_b)]:
        raise AssertionError("ubench single product != a b mod p")
    if fp.unpack(chain[:, :8]) != want or fp.unpack(lane[:, :8]) != want:
        raise AssertionError("ubench chain or lane baseline != a b^R mod p")
    for name, args in (("ubench_mul", [A, Bm]), ("ubench_mul_chain", [A, Bm, UBENCH_R]),
                       ("norm3", [A])):
        err = _hold(name, args, f"S={S}")
        row = out.setdefault(name, {})
        row.update(max_abs_err=max(row.get("max_abs_err", 0), err), slice4_path_S=S,
                   slice4_path_call_ms=_median_ms(lambda: _op(name)(*args), reps=5))
    # each kernel's device ms and bound at 4,096 lanes and at the
    # reference's width (the chain at R = 40)
    cuts = {}
    for width in (4096, S):
        a, b = A[:, :width].contiguous(), Bm[:, :width].contiguous()
        cuts[width] = {"ubench_mul_chain": [a, b, UBENCH_R], "ubench_mul": [a, b], "norm3": [a]}
    # norm3 also cold: its input fits the 50 MB L2 between launches, and its
    # bound is DRAM's bytes, so a write of 256 MiB clears the L2 before
    # each launch (outside the kernel's own device time)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)
    for name in ("ubench_mul_chain", "ubench_mul", "norm3"):
        row, op = out[name], _op(name)
        for width, by_name in cuts.items():
            args = by_name[name]
            ms, by = _kernel_ms(name, lambda: op(*args))
            row[f"ms_S{width}"] = ms
            row[f"bound_ms_S{width}"] = bound_ms(name, args, [op(*args)])[0]
            if by != "profiler":
                row[f"ms_S{width}_timed_by"] = by
            if name == "norm3":
                ms, by = _kernel_ms(name, lambda: (flush.fill_(0), op(*args)))
                row[f"cold_ms_S{width}"] = ms
                if by != "profiler":
                    row[f"cold_ms_S{width}_timed_by"] = by
        say("ubench", kernel=name, **({"R": UBENCH_R} if name == "ubench_mul_chain" else {}),
            **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in row.items()
               if k.startswith(("ms_S", "cold_ms_S", "bound_ms_S"))})
    del flush
    # the reference's width, then the BLS path's widest bucket
    runs = {}
    for width in (S, 1024):
        res = runs[width] = U.run(width, UBENCH_R, DEVICE,
                                  out=lambda line: say("ubench", line=repr(line)))
        if not res["ok"]:
            raise AssertionError(f"ubench_mul.run at S={width}: a product was wrong")
        say("ubench", card=repr(card), S=width, R=UBENCH_R,
            chain_ms_per_mul=f"{res['chain_ms'] / UBENCH_R:.5f}",
            lane_ms_per_mul=f"{res['lane_ms'] / UBENCH_R:.5f}",
            single_ms=f"{res['single_ms']:.5f}",
            lane_over_chain=f"{res['lane_ms'] / res['chain_ms']:.3f}")
    return runs


def phase_ladders(card: str) -> tuple:
    """Slice 4's paths: the ladders at bucket 1024, the unfused Miller
    doubling at 128 lanes, the microbenchmark at S = 110,592, R = 40."""
    out = {}
    walls = _ladders_1024(card, out)
    _unfused_doubling(out)
    ub = _ubench(card, out)
    launches = {}
    for per in (PER_LADDERS, PER_UNFUSED, PER_UBENCH):
        for k, v in per.items():
            launches[k] = launches.get(k, 0) + v
    return out, launches, dict(walls=walls, ubench=ub)


# ------------------------------------------------------------ phase 8: state
# The north star's registry, 2^20 - 5 validators (a count that is not a
# power of two, so that the registry's tree and both lists' trees meet a
# layer of odd width): the cold roots of a state's `validators` (each
# Validator's 8-field tree over its pubkey's 2-chunk tree), `balances` and
# `inactivity_scores`, then the epoch pass over the same count of
# validators.
STATE_N = (1 << 20) - 5
STATE_SEED = SEED + 21
REGISTRY_LIMIT = 1 << 40                # VALIDATOR_REGISTRY_LIMIT
LIST_CHUNK_LIMIT = REGISTRY_LIMIT // 4  # a List[uint64, 2^40]'s chunks
FAR_FUTURE_EPOCH = 2**64 - 1
EPOCH_FIELDS = ("activation_eligibility_epoch", "activation_epoch", "exit_epoch",
                "withdrawable_epoch")
# k_sha256_pairs held on seeded words at these node counts, and on the
# path's own operands at its two widest levels
SHA_S = (1, 261, 32768)
# int32 operations a compression in the reference's count
# (lighthouse_tpu/ops/lane/sha256.py:31-33; a node is two): it counts a
# rotation as three operations and a three-way xor as two, where the card
# does each in one (a funnel shift, a LOP3), so k_sha256_pairs runs under
# it. The bound counts a node's least operations on the card instead, from
# SHA-256's definition: a round 14 (Sigma1 and Sigma0 three funnel shifts
# and a LOP3 each, ch and maj a LOP3 each, T1 two three-input adds, a and e
# one each), a schedule step 10 (sigma0 and sigma1 4 each, its sum 2), 48
# steps in the data block and none in the constant padding block, each
# block's feed-forward 8; the data block's first round, on the constant IV,
# keeps only its two adds of W[0]
SHA_OPS = 2950
SHA_NODE_OPS = 2 * 64 * 14 + 48 * 10 + 2 * 8 - 12
# k_epoch_updates' bytes a validator: five int64 columns and two bool
# read, three int64 and one bool written
EPOCH_BYTES = 5 * 8 + 2 + 3 * 8 + 1
# the epoch pass's three input sets: (label, leak, do_deltas)
EPOCH_SETS = (("leak_off", False, True), ("leak_on", True, True), ("no_deltas", False, False))


def state_columns(rng, n: int) -> dict:
    """A registry of n validators with a real state's column shapes, from a
    seed: pubkey 48 B, withdrawal credentials 32 B (0x01 prefix), effective
    balance, slashed, the four epochs (FAR_FUTURE_EPOCH where not exiting),
    and the uint64 lists balances and inactivity_scores."""
    inc = 10**9
    eff = np.where(rng.random(n) < 0.9, 32, rng.integers(16, 32, n)).astype(np.uint64) * inc
    act = rng.integers(0, 200_000, n).astype(np.uint64)
    exiting = rng.random(n) < 0.05
    exit_e = act + rng.integers(256, 10_000, n).astype(np.uint64)
    far = np.uint64(FAR_FUTURE_EPOCH)
    wc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    wc[:, 0], wc[:, 1:12] = 1, 0
    return {
        "pubkey": rng.integers(0, 256, (n, 48), dtype=np.uint8),
        "withdrawal_credentials": wc,
        "effective_balance": eff,
        "slashed": rng.random(n) < 0.01,
        "activation_eligibility_epoch": act - np.minimum(act, np.uint64(5)),
        "activation_epoch": act,
        "exit_epoch": np.where(exiting, exit_e, far),
        "withdrawable_epoch": np.where(exiting, exit_e + np.uint64(256), far),
        "balances": eff + rng.integers(0, 10**8, n).astype(np.uint64),
        "inactivity_scores": rng.integers(0, 50, n).astype(np.uint64),
    }


def pack_state(cols: dict) -> dict:
    """The leaves as big-endian words (the host pack): each pubkey's two
    chunks [n, 2, 8] (48 bytes, zero-padded); each Validator's eight field
    chunks [n, 8, 8], slot 0 left for its pubkey's root, then one chunk a
    field (uint64 little-endian, the bool one byte, zero-padded); the two
    uint64 lists packed four to a chunk."""
    from lighthouse_tpu_torch.ops.lane import sha256 as H

    n = len(cols["effective_balance"])
    fields = np.zeros((n, 8, 32), np.uint8)
    fields[:, 1] = cols["withdrawal_credentials"]
    fields[:, 2, :8] = cols["effective_balance"].astype("<u8").view(np.uint8).reshape(n, 8)
    fields[:, 3, 0] = cols["slashed"]
    for j, key in enumerate(EPOCH_FIELDS):
        fields[:, 4 + j, :8] = cols[key].astype("<u8").view(np.uint8).reshape(n, 8)
    return {
        "pubkeys": H.words_from_chunks(cols["pubkey"]),
        "fields": H.words_from_chunks(fields.reshape(n, 8 * 32)),
        **{key: H.words_from_chunks(cols[key].astype("<u8").view(np.uint8))
           for key in ("balances", "inactivity_scores")},
    }


def state_to_device(packed: dict, device) -> dict:
    from lighthouse_tpu_torch.ops.lane import sha256 as H

    return {key: H.as_tensor(words, device) for key, words in packed.items()}


def hash_state(t: dict, n: int) -> dict:
    """The roots of the device's leaves `t` (state_to_device): the pubkey
    roots (one launch) into the field chunks' slot 0, the element roots
    (3 launches), the registry's root over them (a launch a level with
    more than one node, the zero spine to 2^40 and the length on the host),
    and both lists' roots the same way."""
    from lighthouse_tpu_torch.ops.lane import merkle as M

    t["fields"][:, 0] = M.reduce_layers(t["pubkeys"])
    elems = M.reduce_layers(t["fields"])
    return {
        "element_roots": elems,
        "validators": M.mix_in_length(M.merkleize(elems, REGISTRY_LIMIT), n),
        **{key: M.mix_in_length(M.merkleize(t[key], LIST_CHUNK_LIMIT), n)
           for key in ("balances", "inactivity_scores")},
    }


def state_launches(n: int) -> dict:
    """hash_state's launches: the pubkey level, the element tree's 3, and
    one a level with more than one node of the registry and each list."""
    from lighthouse_tpu_torch.ops.lane import merkle as M

    lists = len(M.level_pairs((n + 3) // 4))
    return {"sha256_pairs": 1 + 3 + len(M.level_pairs(n)) + 2 * lists}


def state_compressions(n: int) -> tuple:
    """The compressions hash_state runs on the card and on the host (two a
    node): the host's are each tree's zero spine above its device levels
    and its length mix-in."""
    from lighthouse_tpu_torch.ops.lane import merkle as M

    lists = M.level_pairs((n + 3) // 4)
    device = n + 7 * n + sum(M.level_pairs(n)) + 2 * sum(lists)
    host = (40 - len(M.level_pairs(n)) + 1) + 2 * (38 - len(lists) + 1)
    return 2 * device, 2 * host


def _h(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


_HOST_ZEROS = [bytes(32)]
for _ in range(64):
    _HOST_ZEROS.append(_h(_HOST_ZEROS[-1], _HOST_ZEROS[-1]))


def host_merkleize(chunks: list, limit: int) -> bytes:
    """SSZ's merkleize over 32-byte chunks, padded to `limit` leaves, with
    hashlib on the host: the yardstick of the device's trees."""
    depth = (limit - 1).bit_length() if limit > 1 else 0
    if not chunks:
        return _HOST_ZEROS[depth]
    layer = list(chunks)
    for d in range(depth):
        if len(layer) % 2:
            layer.append(_HOST_ZEROS[d])
        layer = [_h(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)]
    return layer[0]


def host_validator_root(cols: dict, i: int) -> bytes:
    """Validator i's hash_tree_root from its columns, by the SSZ rules and
    hashlib alone."""
    pk = cols["pubkey"][i].tobytes()
    leaves = [_h(pk[:32], pk[32:] + bytes(16)), cols["withdrawal_credentials"][i].tobytes(),
              int(cols["effective_balance"][i]).to_bytes(32, "little"),
              bytes([int(cols["slashed"][i])]) + bytes(31),
              *(int(cols[key][i]).to_bytes(32, "little") for key in EPOCH_FIELDS)]
    return host_merkleize(leaves, 8)


def _chunks(data: bytes) -> list:
    data += bytes(-len(data) % 32)
    return [data[i : i + 32] for i in range(0, len(data), 32)]


def epoch_inputs(seed: int, n: int, leak: bool, do_deltas: bool, device) -> tuple:
    """The epoch pass's columns (tensors on `device`) and scalars, drawn as
    tests/test_epoch_columnar.py `_random_program_inputs` draws them, with
    `leak` and `do_deltas` set."""
    rng = np.random.default_rng(seed)
    arrays = {
        "eff": rng.integers(16 * 10**9, 2048 * 10**9, n).astype(np.int64),
        "unslashed_prev": rng.random(n) < 0.8,
        "eligible": rng.random(n) < 0.9,
        "prev_part": rng.integers(0, 8, n).astype(np.int64),
        "scores": rng.integers(0, 10**4, n).astype(np.int64),
        "balances": rng.integers(0, 2049 * 10**9, n).astype(np.int64),
        "slash_penalty": (rng.integers(0, 2, n) * rng.integers(0, 10**9, n)).astype(np.int64),
    }
    scalars = {
        "do_deltas": np.bool_(do_deltas),
        "leak": np.bool_(leak),
        "base_reward_per_inc": np.int64(int(rng.integers(100, 10**6))),
        "total_active_increments": np.int64(int(rng.integers(1, 2**25))),
        "flag_inc_0": np.int64(int(rng.integers(0, 2**25))),
        "flag_inc_1": np.int64(int(rng.integers(0, 2**25))),
        "flag_inc_2": np.int64(int(rng.integers(0, 2**25))),
        "increment": np.int64(10**9),
        "cap": np.int64(32 * 10**9),
        "hysteresis_down": np.int64(10**9 // 4),
        "hysteresis_up": np.int64(10**9 // 2),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}, scalars


def sha_bound_ms(nodes: int, node_ops: int) -> tuple:
    """k_sha256_pairs' least time on `nodes` nodes: 64 B read and 32 B
    written a node, against `node_ops` int32 operations a node."""
    t_bytes = nodes * 96 / PEAK_BYTES_S
    t_ops = nodes * node_ops / PEAK_INT32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def sass_stats(lib: str, kernel: str) -> dict | None:
    """`kernel`'s SASS in this run's build of library `lib` (cuobjdump
    -sass, beside nvcc), a report beside its bound: its instructions (NOPs
    excluded), their opcodes, and how many read a constant bank other than
    the parameters' (c[0x0]); None where the toolkit has no cuobjdump."""
    from lighthouse_tpu_torch.ops.lane import kernels

    cuobjdump = Path(kernels.nvcc_path()).parent / "cuobjdump"
    if not cuobjdump.exists():
        return None
    sass = subprocess.run([str(cuobjdump), "-sass", str(kernels.build_dir() / f"lib{lib}.so")],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    body = next(part for part in sass.split("Function : ")[1:]
                if _short_name(part.split()[0]) == kernel)
    lines = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(.*)", body)
    ops = {}
    for op, _ in lines:
        ops[op] = ops.get(op, 0) + 1
    return {"instructions": len(lines) - ops.get("NOP", 0),
            "bank_operands": sum(bool(re.search(r"c\[0x[1-9a-f]", rest)) for _, rest in lines),
            "by_op": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}


def _state_checks(cols: dict, roots: dict, n: int) -> None:
    """1,024 sampled element roots against host_validator_root; the
    registry's upper tree over the device's element roots, and both lists'
    roots, against host_merkleize (about 1.5 M hashlib calls)."""
    from lighthouse_tpu_torch.ops.lane import sha256 as H

    elems = H.chunks_from_words(roots["element_roots"])
    sample = np.random.default_rng(STATE_SEED + 9).choice(n, 1024, replace=False)
    bad = [int(i) for i in sample
           if elems[32 * i : 32 * i + 32] != host_validator_root(cols, int(i))]
    if bad:
        raise AssertionError(f"state: element roots != hashlib at validators {bad[:8]}")
    want = _h(host_merkleize(_chunks(elems), REGISTRY_LIMIT), n.to_bytes(32, "little"))
    if roots["validators"] != want:
        raise AssertionError("state: the registry's root != the host merkleize over its elements")
    for key in ("balances", "inactivity_scores"):
        data = cols[key].astype("<u8").tobytes()
        want = _h(host_merkleize(_chunks(data), LIST_CHUNK_LIMIT), n.to_bytes(32, "little"))
        if roots[key] != want:
            raise AssertionError(f"state: the {key} root != the host merkleize")


def _sha_holds(dev: dict, n: int, out: dict) -> None:
    """k_sha256_pairs against its plain body: seeded words at SHA_S, and
    the path's own operands at its pubkey level (n pairs) and at the
    element tree's first level, its widest (4n pairs, read in place);
    device ms and bound at each, call and plain ms at n."""
    from lighthouse_tpu_torch.ops.lane import sha256 as H

    g = np.random.default_rng(STATE_SEED + 5)
    cases = {S: tuple(H.as_tensor(g.integers(0, 1 << 32, (S, 8), dtype=np.uint32), DEVICE)
                      for _ in range(2)) for S in SHA_S}
    pk, fields = dev["pubkeys"].reshape(-1, 8), dev["fields"].reshape(-1, 8)
    cases[n] = (pk[0::2], pk[1::2])
    cases[4 * n] = (fields[0::2], fields[1::2])
    row = out["sha256_pairs"]
    for S, args in cases.items():
        row["max_abs_err"] = max(row["max_abs_err"], _hold("sha256_pairs", args, f"S={S}"))
        ms, by = _kernel_ms("sha256_pairs", lambda: H.digest_pairs(*args))
        row[f"ms_S{S}"], row[f"bound_ms_S{S}"] = ms, sha_bound_ms(S, SHA_NODE_OPS)[0]
        if by != "profiler":
            row[f"ms_S{S}_timed_by"] = by
    args = cases[n]
    row.update(ms=row[f"ms_S{n}"], call_ms=_median_ms(lambda: H.digest_pairs(*args)),
               plain_ms=_median_ms(lambda: H.digest_pairs.plain(*args), reps=3, warm=1))
    row["bound_ms"], row["bound_by"] = sha_bound_ms(n, SHA_NODE_OPS)
    say("state", kernel="sha256_pairs", equal="yes", tolerance="exact(torch.equal)",
        S="|".join(map(str, cases)), ptxas=json.dumps(PTXAS.get("sha256_pairs", {})),
        **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in row.items()})


def _epoch_holds(sets: dict, n: int, out: dict) -> None:
    """k_epoch_updates against its plain body at n validators on each of
    EPOCH_SETS; device ms warm and with the L2 cleared before each launch
    (a 256 MiB write), call and plain ms, on the first set."""
    from lighthouse_tpu_torch.ops import epoch as E

    row = out["epoch_updates"]
    for label, args in sets.items():
        row["max_abs_err"] = max(row["max_abs_err"], _hold("epoch_updates", args, label))
    args = sets[EPOCH_SETS[0][0]]
    ms, by = _kernel_ms("epoch_updates", lambda: E.updates(*args))
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)
    cold, cold_by = _kernel_ms("epoch_updates", lambda: (flush.fill_(0), E.updates(*args)))
    del flush
    row.update({"ms": ms, f"ms_S{n}": ms, f"cold_ms_S{n}": cold,
                "call_ms": _median_ms(lambda: E.updates(*args)),
                "plain_ms": _median_ms(lambda: E.updates.plain(*args), reps=5, warm=1),
                "bound_ms": n * EPOCH_BYTES / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
                f"bound_ms_S{n}": n * EPOCH_BYTES / PEAK_BYTES_S * 1e3})
    for key, how in (("ms", by), ("cold_ms", cold_by)):
        if how != "profiler":
            row[f"{key}_S{n}_timed_by"] = how
    say("state", kernel="epoch_updates", equal="yes", tolerance="exact(torch.equal)",
        sets=",".join(sets), S=n, ptxas=json.dumps(PTXAS.get("epoch_updates", {})),
        **{k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in row.items()})


def _numpy_entries(packed: dict, sets: dict, out: dict) -> None:
    """The reference's contracts on the card, numpy in and out:
    compress_pairs on the pubkey level's words and epoch_updates on the
    first epoch set's columns, each equal to its tensor entry on the same
    operands; their call ms (the copies both ways included), beside the
    epoch pass's plain body on the host's CPU on the same columns."""
    from lighthouse_tpu_torch.ops import epoch as E
    from lighthouse_tpu_torch.ops.lane import sha256 as H

    left, right = packed["pubkeys"][:, 0], packed["pubkeys"][:, 1]
    got = H.compress_pairs(left, right)
    want = H.digest_pairs(H.as_tensor(left, DEVICE), H.as_tensor(right, DEVICE))
    if got.dtype != np.uint32 or not np.array_equal(got, want.cpu().numpy().view(np.uint32)):
        raise AssertionError("compress_pairs on the card != digest_pairs")
    arrays, scalars = sets[EPOCH_SETS[0][0]]
    cols = {k: v.cpu().numpy() for k, v in arrays.items()}
    host = {k: v.cpu() for k, v in arrays.items()}
    got = E.epoch_updates(cols, scalars)
    for g, w in zip(got, E.updates(arrays, scalars), strict=True):
        if not (isinstance(g, np.ndarray) and np.array_equal(g, w.cpu().numpy())):
            raise AssertionError("epoch_updates on the card != updates")
    ms = {"sha256_pairs": statistics.median(
              _wall(lambda: H.compress_pairs(left, right)) for _ in range(5)) * 1e3,
          "epoch_updates": statistics.median(
              _wall(lambda: E.epoch_updates(cols, scalars)) for _ in range(5)) * 1e3}
    host_ms = statistics.median(_wall(lambda: E.updates(host, scalars)) for _ in range(3)) * 1e3
    out["sha256_pairs"]["numpy_entry_call_ms"] = ms["sha256_pairs"]
    out["epoch_updates"].update(numpy_entry_call_ms=ms["epoch_updates"], host_plain_ms=host_ms)
    say("state", compress_pairs="== digest_pairs", nodes=len(left),
        call_ms=f"{ms['sha256_pairs']:.4f}")
    say("state", epoch_updates="== updates", validators=len(cols["eff"]),
        call_ms=f"{ms['epoch_updates']:.4f}", host_plain_ms=f"{host_ms:.4f}")


def phase_state(card: str) -> tuple:
    """Phase 8: a registry of STATE_N validators, its cold roots and its
    epoch pass, the launch counters zeroed just before and read just after;
    the roots against hashlib, both kernels against their plain bodies, the
    numpy entries against the tensor entries."""
    from lighthouse_tpu_torch.ops import epoch as E

    n = STATE_N
    cols = state_columns(np.random.default_rng(STATE_SEED), n)
    t = time.perf_counter()
    packed = pack_state(cols)
    pack_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    dev = state_to_device(packed, DEVICE)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t
    sets = {label: epoch_inputs(STATE_SEED + i, n, leak, deltas, DEVICE)
            for i, (label, leak, deltas) in enumerate(EPOCH_SETS)}
    launches = {**state_launches(n), "epoch_updates": 1}
    (roots, _), path_s = _window("state", launches, lambda: (
        hash_state(dev, n), E.updates(*sets[EPOCH_SETS[0][0]])), phase="state")
    _state_checks(cols, roots, n)
    say("state", validators=n, element_roots="1,024 sampled == hashlib",
        registry_root="== host merkleize over the device's element roots (limit 2^40, length "
        "mixed in)", balances_root="== host merkleize", inactivity_scores_root="== host merkleize")
    events, tries = _profiled(lambda: hash_state(dev, n), state_launches(n))
    wall = statistics.median(_wall(lambda: hash_state(dev, n)) for _ in range(5))
    comp, host_comp = state_compressions(n)
    bound, bound_by = sha_bound_ms(comp // 2, SHA_NODE_OPS)
    leaf_bytes = sum(w.nbytes for w in packed.values())
    say("state", card=repr(card), host_pack_s=f"{pack_s:.4f}", leaf_bytes=leaf_bytes)
    say("state", h2d_s=f"{h2d_s:.4f}")
    tot = device_totals(events) if events is not None else None
    if tot is None:
        say("state", device_ms=f"not_measured(no whole trace in {tries} tries)")
    else:
        glue = {}
        for e in events:
            if not re.search(r"\bk_\w+", e.key):
                k = _short_key(e.key)
                c, ms = glue.get(k, (0, 0.0))
                glue[k] = (c + 1, ms + _device_time(e) / 1e3)
        say("state", device_ms=f"{tot['device_ms']:.5f}", counted="once(device_totals)",
            glue_ms=f"{tot['glue_ms']:.5f}", trace_tries=tries,
            glue=json.dumps({k: [c, round(ms, 5)] for k, (c, ms) in glue.items()},
                            separators=(",", ":")),
            kernels_ms=json.dumps({k: round(v, 5) for k, v in tot["kernels_ms"].items()}))
    say("state", launches=json.dumps(launches, separators=(",", ":")))
    say("state", compressions=comp, host_compressions=host_comp)
    for name, lib in (("sha256_pairs", "sha256"), ("epoch_updates", "epoch")):
        st = sass_stats(lib, f"k_{name}")
        say("state", kernel=name, sass=json.dumps(st, separators=(",", ":")) if st else
            "not_measured(no cuobjdump)")
    say("state", bound_ms=f"{bound:.5f}", bound_by=bound_by, ops_per_node=SHA_NODE_OPS,
        reference_count_ms=f"{sha_bound_ms(comp // 2, 2 * SHA_OPS)[0]:.5f}")
    say("state", hash_wall_s=f"{wall:.4f}", path_wall_s=f"{path_s:.4f}")
    out = {"sha256_pairs": {"max_abs_err": 0,
                            "state_path_device_ms": _kernel_share(tot, "sha256_pairs")},
           "epoch_updates": {"max_abs_err": 0}}
    _sha_holds(dev, n, out)
    _epoch_holds(sets, n, out)
    _numpy_entries(packed, sets, out)
    return out, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import lighthouse_tpu_torch  # noqa: F401  (fails outside the repository)

    t_all = time.perf_counter()
    card = phase_card()
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), card=repr(card))

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        say("phase", name=name, seconds=f"{time.perf_counter() - t:.1f}")
        return out

    timed("build", phase_build)
    per_kernel = timed("kernels", phase_kernels)
    timed("pairing128", phase_pairing128)
    launches_kzg = timed("e2e", phase_e2e)
    per_bls, launches = timed("bls", lambda: phase_bls(card))
    per_s4, launches_s4, _ = timed("ladders", lambda: phase_ladders(card))
    per_state, launches_state = timed("state", lambda: phase_state(card))
    rows = []
    for name, (src, replaces) in KERNELS.items():
        parts = [d[name] for d in (per_kernel, per_bls, per_s4, per_state) if name in d]
        k = {kk: v for d in parts for kk, v in d.items()}
        k["max_abs_err"] = max(d.get("max_abs_err", 0) for d in parts)
        # launches: the main path's for its kernels, slice 4's paths' and
        # phase 8's for theirs, none for a kernel no path launches
        n = (launches[name] if name in BLS_KERNELS
             else launches_s4[name] if name in SLICE4_KERNELS
             else launches_state[name] if name in STATE_KERNELS else launches.get(name, 0))
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": n, "launches_kzg": launches_kzg.get(name, 0),
            "launches_slice4": launches_s4.get(name, 0),
            "launches_state": launches_state.get(name, 0),
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            # the CUDA-event call ms at S=4096 and at each path's own width
            **{key: k[key] for key in ("call_ms", "path_S", "path_call_ms", "bls_path_S",
                                       "bls_path_call_ms", "slice4_path_S",
                                       "slice4_path_call_ms", "slice4_path_device_ms",
                                       "state_path_device_ms", "numpy_entry_call_ms",
                                       "host_plain_ms")
               if key in k},
            # the cooperative kernels' device ms and bound at each
            # path width, and their blocks' dynamic shared memory
            **{key: v for key, v in k.items()
               if key.startswith(("ms_S", "cold_ms_S", "bound_ms_S", "latency_floor_ms"))},
            "ptxas": PTXAS.get(name, {}),
            **({"launch_smem": LAUNCH_SMEM[name]} if name in LAUNCH_SMEM else {}),
        })
    say("phase", name="all", seconds=f"{time.perf_counter() - t_all:.1f}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
