"""Programs of the cooperative pairing kernels (csrc/coop.cuh).

A cooperative kernel gives each lane element a thread block of NW warps.
The element's state lives in the block's shared memory as rows of W limbs,
and each Fp product or `reduce_light` is one warp's job, limb-parallel
across its 32 threads. A program says which jobs run and where
their operands and results live. Its jobs fall into stages: the jobs of a
stage are independent, the block's warps share them out, and a block
barrier ends each stage.

The programs are traced here from the plain bodies themselves
(pairing._dbl_iter_body, pairing._cyc_sqr_body, jacobian._dbl_f2_body,
chains._win_core_f2, tower._f12mul_body, chains._inv_w4_body,
fp._inv_bin_body, jacobian._add_core_f2, chains._win_core_f1,
htc._ratio_table_body, htc._ratio_win_body, pairing._add_iter_body,
tower._f2mul_body, tower._f2sqr_body, jacobian._dbl_f1_body,
jacobian._add_core_f1, jacobian._add_exact_core_f1, tower._f6mul_body,
fp._mul_fn, tower._f12sqr_body, tower._f12mul_034_body, fp._sqr_fn): run
on symbolic rows,
each of their Fp products, squares and `reduce_light`s becomes a job whose operands
are the integer combinations of rows that the body's lazy sums (a0 + a1,
3 t - 2 c, f2mul_xi, ...) made, and a job evaluates them limb by limb
where it reads its operands. A lazy sum is an exact linear combination of
int32 limbs, inside the limb-bounds certificate, so the order of its adds
does not change the limbs. The Fp products, squares and `reduce_light`
keep `_SCHED`'s carry passes; the device computes each one as
fp._mul_body (both entry norms), fp._sqr_fn (one entry norm, at
`sqr.entry`, then the operand times itself) and fp._reduce_light_body do.
A square is a job kind of its own: `MUL(a, a)` would run two entry norms
at `mul.entry_*` and give other lazy limbs.

A program holds no select: a `torch.where` or a comparison on a traced
value raises. A body with a per-element select (the window step's digit,
the add's structural infinity) is traced without it, and its kernel makes
the select after the program, in an epilogue: one block is one lane
element, so the select is uniform over the block and only picks which
rows the block loads or writes (csrc/chains.cu `win_step`, csrc/jac_add.cu
`add` and `add_exact`, whose epilogue also runs canonical() on two of the
program's outputs).

A program holds no loop either: a chain whose steps repeat is two
programs, one run once and one run a step at a time by its kernel, which
moves the step's operands between runs (CHAINS; csrc/htc.cu).

A kernel may also run programs that other kernels run, in one block: a
per-lane ladder step runs the add's program, where its lane element's
bit is set, then the doubling's (LADDERS; csrc/ladder.cu). The bit is a
select like the add's infinity, uniform over the block, so where it is
clear the block skips the add's program.

A one-job program (the standalone `mul` and `sqr`) would leave all but one
warp of such a block idle, and the block's copy of the tables would cost as
much as its job. Its kernel lays the block out by warp instead (PER_WARP): a
block of NW warps holds one copy of the tables and NW lane elements at a
time, one a warp, each warp running the whole program on its own rows
(csrc/coop.cuh `run_warp`).

Each job is scheduled at the earliest stage its operands allow, and its
result takes the lowest shared-memory row that no later stage reads. The
encoded program (int32 words) is compiled into the library's constant
bank: `header` writes them all into one generated header that kernels.build
hands to nvcc, and checks that they fit the bank beside fp_lane.cuh's
tables. `run_reference` executes an encoded program on CPU tensors with the
plain Fp bodies, checking that no stage writes a row that the same stage
reads: the CPU tests hold it limb for limb against the plain bodies.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from . import chains, fp, htc, jacobian, pairing, tower

W = fp.W

# job kinds and the word layout, mirrored by csrc/coop.cuh (pinned by
# tests/test_torch_coop.py)
MUL, RL, SQR = 0, 1, 2
H_STAGES, H_JOBS, H_ROWS, H_OUTS, H_INS, H_STAGE0 = 0, 1, 2, 3, 4, 5
JOB_WORDS = 3          # kind | na << 8 | nb << 16, out row, term offset
OUT_WORDS = 2          # term offset, term count
MAX_WORDS = 4096       # per program: a quarter of the 64 KiB constant bank
BANK_WORDS = 16384     # the 64 KiB constant bank, in int32 words
MAX_TERMS = 255        # terms of one operand: the job word counts them in 8 bits
SCRATCH = 164          # a warp's scratch: its padded product operand, a dump row
NFOLD, CONVW = 41, 73
TABLES = W * NFOLD + 3 * CONVW  # FOLDS and TOPFM, copied into shared memory

# program slot -> (name, warps per lane element). jac_dbl_f2 and
# g2_win_step run at the 1,024-lane bucket. More warps shorten a block
# (jac_dbl_f2's stages hold 7, 8, 4, 2, 3, 2, 2 jobs: 9 job rounds on 4
# warps, 7 on 8; g2_win_step's 23 stages of 2-13 jobs: 42 on 4, 29 on 8),
# but fewer blocks share an SM at 64 registers a thread (coop.cuh
# min_blocks): with 4 warps 8, so 1,024 blocks fit the H100's 132 SMs in
# one wave, and at that width 4 warps time fastest (tools/coop_warps.py).
# f12mul's stages hold 54 products, then 36 and 18 reduce_light: 5 job
# rounds on 32 warps, 9 on 16. 36 of its 46 launches a verify run at one
# lane, the other 10 at the lane product's widths 512 ... 1; summed over
# that mix 32 warps time 3 % under 16 (tools/coop_warps.py). The
# inversion chains are serial: inv_w4's stages hold one job each (1 warp),
# inv_bin's a bit's product and square side by side (2 warps).
# jac_add_f2's 10 stages hold 12, 12, 10, 9, 10, 6, 5, 5, 2, 2 jobs: 23
# rounds on 4 warps, 15 on 8. 25 of its 35 launches a bucket-1024 verify
# run at 1,024 lanes (4 warps 0.0694 ms, 8 warps 0.0727), the lane sum's
# 10 at 512 ... 1 (4 warps 0.0380-0.0228, 8 warps 0.0392-0.0184): over
# that mix 4 warps take 1.987 ms and 8 warps 2.032. g1_win_step's 18
# stages hold 1-4 jobs: 25 rounds on 2 warps, 18 on 4; 4 warps time
# faster at one lane (0.0209 against 0.0256 ms) and at 1,024, where all
# 32 launches a verify run (0.0493 against 0.0505). The ratio chain's
# two programs run in one block, so on one warp count: its window's stages
# hold 2, 2, 3, 2 jobs, 9 rounds on 1 warp, 5 on 2, 4 on 3 and 4; its one
# launch a verify runs at twice the bucket's width. On 1 / 2 / 3 / 4
# warps: 2,048 lanes (bucket 1024) 3.749 / 4.137 / 3.768 / 3.807 ms, 256
# (bucket 128) 1.645 / 0.992 / 0.866 / 0.967, one lane 1.640 / 0.977 /
# 0.785 / 0.919: 3 warps (10 blocks an SM). miller_add_iter's 10 stages
# hold 5, 5, 5, 9, 17, 17, 26, 17, 20, 14 jobs: 26 rounds on 6 warps, 23
# on 8, 18 on 9, 16 on 13; its 10 launches a verify run 5 at 1,024 lanes
# and 5 at one. On 6 / 8 / 9 / 13 warps one lane takes 0.0349 / 0.0322 /
# 0.0295 / 0.0284 ms, 1,024 lanes 0.1270 / 0.1253 / 0.1287 / 0.1343: 8
# warps take the least over that mix (0.788 ms, 9 warps 0.791). f2mul's 2
# stages hold 3 products, then 2 reduce_light: 2 rounds on 3 warps, 3 on
# 2, 5 on 1; 3 warps time fastest at every width a verify calls it (1-512
# lanes 0.0045-0.0065 ms, 1,024 0.0089, 2,048 0.0153, 4 x 2,048 0.0481).
# f2sqr's one stage holds 2 products: 2 rounds on 1 warp, 1 on 2 and 3;
# of its 51 launches a bucket-1024 verify 16 run at 1-64 lanes, 6 at
# 128-512, 17 at 1,024, 10 at 2,048 and 2 at 4 x 2,048. On 1 / 2 / 3
# warps one lane takes 0.00596 / 0.00452 / 0.00395 ms, 512 0.00659 /
# 0.00570 / 0.00526, 1,024 0.00810 / 0.00714 / 0.00682, 2,048 0.01152 /
# 0.01064 / 0.01143, 4 x 2,048 0.03531 / 0.03447 / 0.03470: 3 warps take
# the least over that mix (0.394 ms, 2 warps 0.403; the block's copy of
# the tables goes faster on more threads). The MSM's G1 group ops run 334
# doublings and 78 adds at 4,096 lanes a commit, and 12 of each in its
# lane sum at 2,048 ... 1. jac_dbl_f1's 6 stages hold 3, 4, 1, 1, 1, 1
# jobs: 11 rounds on 1 warp, 8 on 2, 7 on 3, 6 on 4; at 4,096 lanes 1 / 2
# / 3 / 4 warps take 0.04727 / 0.05082 / 0.04646 / 0.04873 ms, at one lane
# 0.01267 / 0.00962 / 0.00786 / 0.00759; over the commit's mix 3 warps take
# the least (15.64 ms, 4 warps 16.40, 1 warp 15.96). jac_add_f1's 7 stages
# hold 5, 5, 3, 3, 2, 1, 1 jobs: 13 rounds on 2 warps, 9 on 3 and 4, 7 on
# 5; at 4,096 lanes 2 / 3 / 4 / 5 warps take 0.09915 / 0.09506 / 0.09484 /
# 0.10149 ms, at one lane 0.01634 / 0.01373 / 0.01286 / 0.01198; over the
# mix 4 warps take the least (7.616 ms, 3 warps 7.641, 5 warps 8.133).
# add_exact_f1 runs the commit's 90 exact adds (78 at 4,096 lanes, 12 at
# 2,048 ... 1) and a verify's one at its bucket's width; its 31 jobs take
# 13 rounds on 3 warps, 10 on 4 and 9 on 5 and 6. On 3 / 4 / 5 / 6 warps
# one lane takes 0.01954 / 0.01709 / 0.01722 / 0.01698 ms, 128 lanes
# 0.02026 / 0.01786 / 0.01798 / 0.01770, 4,096 0.15738 / 0.15834 /
# 0.16669 / 0.17028; over the commit's mix 12.616 / 12.668 / 13.333 /
# 13.612 ms: 3 and 4 warps within 0.5 %; 4, faster at the verify's widths.
# f6mul's 3 stages hold 18 products, then 12 and 6 reduce_light: 3 rounds
# on 18 and 32 warps, 4 on 12 and 16, 5 on 9, 6 on 6; all its launches (4
# a verify, 4 a KZG check) run at one lane. On 6 / 9 / 12 / 18 warps one
# lane takes 0.00886 / 0.00824 / 0.00773 / 0.00759 ms, 1,024 lanes 0.03294
# / 0.03513 / 0.03721 / 0.05184, 4,096 0.11406 / 0.12210 / 0.13393 /
# 0.20064, but 12 and 18 warps do not divide 32, so their launch bound
# lets ptxas take 80 registers; at the 64-register cap 16 warps take
# 0.00820 at one lane (0.04039 at 1,024) and 32 warps 0.00746 (0.05383):
# 32. mul (PER_WARP: warps a block, a lane element each) runs 11
# launches a verify, 2 at 12 x 1, 4 at 2 x 1, 3 at 1,024 and 2 at 2 x
# 1,024. On 1 / 2 / 4 / 8 / 16 / 32 warps 12 x 1 takes 0.00446 / 0.00509 /
# 0.00483 / 0.00516 / 0.00604 / 0.00625 ms, 2 x 1 0.00446 / 0.00507 /
# 0.00483 / 0.00470 / 0.00488 / 0.00513, 1,024 0.00578 / 0.00589 / 0.00546
# / 0.00542 / 0.00677 / 0.00957, 2 x 1,024 0.00789 / 0.00747 / 0.00693 /
# 0.00681 / 0.00686 / 0.00961, 4,096 0.01285 / 0.01054 / 0.00969 / 0.00960
# / 0.00977 / 0.00977, 110,592 0.23720 / 0.18999 / 0.17609 / 0.18166 /
# 0.21031 / 0.22892: over a verify's mix 8 warps take the least (0.0590
# ms; 4 warps 0.0592, 1 warp 0.0599). f12sqr's 3 stages hold 36 products,
# then 24 and 12 reduce_light: 4 rounds on 32 warps, 6 on 16, 10 on 8;
# f12mul_034's 2 stages 39 products, then 26 reduce_light: 3 / 5 / 9.
# Both run only on the unfused Miller doubling, 63 launches each at 128
# lanes. On 8 / 16 / 32 warps f12sqr takes 0.01433 / 0.01277 / 0.01248 ms
# at 128 lanes (one lane 0.01322 / 0.01162 / 0.01104, 4,096 lanes 0.21767
# / 0.23921 / 0.32777): 32; f12mul_034 0.01476 / 0.01310 / 0.01320 at 128
# lanes (one lane 0.01359 / 0.01169 / 0.01191, 4,096 0.23033 / 0.24961 /
# 0.34952): 16, also faster at 4,096. sqr (PER_WARP, as mul) runs one
# launch a verify, at 1 x 128 or 1 x 1,024 (the bucket's width). On 1 / 2 /
# 4 / 8 / 16 / 32 warps 1 x 128 takes 0.00439 / 0.00466 / 0.00452 /
# 0.00489 / 0.00607 / 0.00872 ms, 1 x 1,024 0.00566 / 0.00538 / 0.00499 /
# 0.00496 / 0.00618 / 0.00883, one lane 0.00425 / 0.00459 / 0.00437 /
# 0.00434 / 0.00447 / 0.00469, 4,096 0.01136 / 0.00976 / 0.00901 / 0.00888
# / 0.00897 / 0.00902: over the two buckets 4 warps take the least
# (0.00951 ms; 8 warps 0.00985, 1 warp 0.01005).
# Device ms from tools/coop_warps.py on an NVIDIA H100 80GB HBM3 at 700 W.
PROGRAMS = {0: ("miller_dbl_iter", 8), 1: ("cyc_sqr", 9), 2: ("jac_dbl_f2", 4),
            3: ("g2_win_step", 4), 4: ("f12mul", 32), 5: ("inv_w4", 1), 6: ("inv_bin", 2),
            7: ("jac_add_f2", 4), 8: ("g1_win_step", 4), 9: ("ratio_table", 3),
            10: ("ratio_win", 3), 11: ("miller_add_iter", 8), 12: ("f2mul", 3),
            13: ("f2sqr", 3), 14: ("jac_dbl_f1", 3), 15: ("jac_add_f1", 4),
            16: ("add_exact_f1", 4), 17: ("f6mul", 32), 18: ("mul", 8),
            19: ("f12sqr", 32), 20: ("f12mul_034", 16), 21: ("sqr", 4)}
# kernels laid out one warp per lane element (NW elements a block at a
# time, one copy of the tables): PROGRAMS gives their warps a block. For
# sqr this layout was timed against one thread an element reading its
# tables from shared memory: about half the device time at 1 x 128 and
# 1 x 1,024 (0.00452 / 0.00499 ms against 0.01039 / 0.01043 at 64 threads
# a block, PERF.md §6)
PER_WARP = frozenset({"mul", "sqr"})
# kernel -> its programs, where it runs more than one: the ratio chain
# (csrc/htc.cu) runs the table's once, then the window's once a digit of
# htc._WIN_IDX, the table's outputs (its 16 entries) kept in rows above
# the window's
CHAINS = {"ratio_chain": ("ratio_table", "ratio_win")}
# kernels that run other kernels' programs in one block, on a warp count
# of their own: kernel -> (its programs, warps per lane element). The
# per-lane ladder step (csrc/ladder.cu) runs the add's program where the
# lane element's bit is set, then the doubling's; the programs stay where
# jac_add.cu and jac_dbl.cu run them, so the ladders add no word to the
# bank. With 2 / 4 / 8 warps G1's add and doubling take 13 + 8 / 9 + 6 /
# 7 + 6 job rounds, G2's 38 + 15 / 23 + 9 / 15 + 7. All 64 launches of a
# ladder run at its batch's width, 1,024 lanes for a gossip batch. With
# random bits, on 2 / 4 / 8 warps ladder_step_f1 takes 0.02331 / 0.01767 /
# 0.01670 ms at one lane (its bit set), 0.04174 / 0.03751 / 0.04466 at
# 1,024 lanes and 0.12715 / 0.12458 / 0.14948 at 4,096: 4 warps;
# ladder_step_f2 0.01742 / 0.01083 / 0.00909 at one lane (its bit clear:
# the doubling alone), 0.09683 / 0.09011 / 0.08451 at 1,024 and 0.28837 /
# 0.26677 / 0.26786 at 4,096: 8 warps (4 blocks an SM, so 1,024 lanes take
# two waves, of 22 job rounds a block against 32 on 4 warps). On 4 warps
# (8 blocks an SM, one wave at 1,024 lanes) a step with every bit set
# takes about as long as one with half of them: the blocks that skip the
# add end early, but the wave lasts as long as its blocks that run it.
# Device ms from tools/coop_warps.py on an NVIDIA H100 80GB HBM3 at 700 W.
LADDERS = {"ladder_step_f1": (("jac_add_f1", "jac_dbl_f1"), 4),
           "ladder_step_f2": (("jac_add_f2", "jac_dbl_f2"), 8)}


FP, FP2, FP6, FP12 = (), (2,), (3, 2), (2, 3, 2)


def _lin(v: torch.Tensor) -> dict:
    """The {row: coefficient} of one traced value (its coefficient vector)."""
    v = v.as_subclass(torch.Tensor)
    return {int(r): int(v[r]) for r in v.nonzero().flatten().tolist()}


_SELECTS = frozenset({torch.where, torch.Tensor.where, torch.masked_select,
                      torch.Tensor.masked_fill, torch.Tensor.masked_fill_,
                      torch.Tensor.masked_scatter})


class Traced(torch.Tensor):
    """A traced value's coefficient tensor. Linear operations pass through;
    a select (`torch.where`, a masked fill) or anything that yields a bool
    tensor (a comparison, the flag of a select) raises: a program has no
    per-element select."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", repr(func))
        if func in _SELECTS:
            raise ValueError(_select_error(name))
        out = super().__torch_function__(func, types, args, kwargs or {})
        flat = out if isinstance(out, (tuple, list)) else (out,)
        if any(isinstance(o, torch.Tensor) and o.dtype == torch.bool for o in flat):
            raise ValueError(_select_error(name))
        return out


def _select_error(name: str) -> str:
    return (f"`{name}` on a traced value: a per-element select (torch.where, a "
            "comparison such as the structural-infinity or digit test) has no job "
            "in a cooperative program; trace the arithmetic without it and make "
            "the select block-uniform in the kernel's epilogue")


class Tracer:
    """A plain body's jobs, recorded by running the body on symbolic rows.

    A traced value is an int64 tensor [..., 1, N]: its W axis cut to one
    limb, its lane axis holding its coefficients over the rows (the
    inputs, then each job's result). The bodies' lazy sums, stacks and
    component slices are linear, so they compute every operand's
    combination exactly; the tracer stands in for `folds`, and the Fp
    bodies that see it (`_mul_body`, `_sqr_fn`, `_reduce_light_body`, see
    `_tracing`) record one job per element of the stack they are given and
    return that many fresh rows."""

    N = 640  # rows a traced value can name (inv_bin names 611)

    def __init__(self, fields):
        self.n_in = sum(int(np.prod(c, dtype=np.int64)) for c in fields)
        self.n = 0
        self.jobs = []  # (kind, out row, operand {row: coefficient} dicts)
        self.inputs = [self._fresh(c) for c in fields]

    def _fresh(self, lead):
        n = int(np.prod(lead, dtype=np.int64))
        if self.n + n > self.N:
            raise ValueError(f"a program of more than {self.N} rows")
        out = torch.zeros((n, 1, self.N), dtype=torch.int64)
        out[torch.arange(n), 0, self.n + torch.arange(n)] = 1
        self.n += n
        return out.reshape(*lead, 1, self.N).as_subclass(Traced)

    def record(self, kind, *ops):
        ops = torch.broadcast_tensors(*ops)
        flat = [op.reshape(-1, self.N) for op in ops]
        for e in range(flat[0].shape[0]):
            self.jobs.append((kind, self.n + e, tuple(_lin(f[e]) for f in flat)))
        return self._fresh(ops[0].shape[:-2])


_TRACE_LOCK = threading.Lock()


@contextlib.contextmanager
def _tracing():
    """fp's three Fp bodies record when their `folds` is a Tracer, and run
    as before for every other caller (a plain body on another thread too)."""
    mul_body, sqr_fn, rl_body = fp._mul_body, fp._sqr_fn, fp._reduce_light_body

    def mul(a, b, folds, topf, norm_a=True, norm_b=True):
        if not isinstance(folds, Tracer):
            return mul_body(a, b, folds, topf, norm_a, norm_b)
        if not (norm_a and norm_b):
            raise ValueError("a warp product normalizes both entries")
        return folds.record(MUL, a, b)

    def sqr(folds, topf, a):
        if not isinstance(folds, Tracer):
            return sqr_fn(folds, topf, a)
        return folds.record(SQR, a)

    def rl(x, folds, topf):
        if not isinstance(folds, Tracer):
            return rl_body(x, folds, topf)
        return folds.record(RL, x)

    with _TRACE_LOCK:
        fp._mul_body, fp._sqr_fn, fp._reduce_light_body = mul, sqr, rl
        try:
            yield
        finally:
            fp._mul_body, fp._sqr_fn, fp._reduce_light_body = mul_body, sqr_fn, rl_body


def trace(body, fields):
    """The jobs of `body(folds, topf, *operands)`, whose operands have the
    component shapes `fields`, and its outputs' rows as {row: coefficient}."""
    t = Tracer(fields)
    with _tracing():
        outs = body(t, None, *t.inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return t, [_lin(v) for o in outs for v in o.reshape(-1, Tracer.N)]


# ------------------------------------------------------------ schedule


def encode(b: Tracer, outs: list) -> np.ndarray:
    """Schedule (earliest stage), allocate rows (lowest free row), encode."""
    level = {r: 0 for r in range(b.n_in)}
    for kind, r, ops in b.jobs:
        level[r] = 1 + max(level[x] for op in ops for x in op)
    n_st = max((level[r] for _, r, _ in b.jobs), default=0)
    last = dict.fromkeys(range(b.n), -1)
    for kind, r, ops in b.jobs:
        for op in ops:
            for x in op:
                last[x] = max(last[x], level[r])
    for o in outs:
        for x in o:
            last[x] = n_st + 1
    if any(last[r] < 0 for _, r, _ in b.jobs):
        raise ValueError("a job's result is never read")
    # stages: products and squares first (the long jobs), then reduce_light
    order = sorted(range(len(b.jobs)),
                   key=lambda j: (level[b.jobs[j][1]], b.jobs[j][0] == RL, j))
    # rows: inputs at 0 .. n_in-1; a result takes the lowest row whose
    # value no stage from its own on reads
    where = {r: r for r in range(b.n_in)}
    holder = {r: r for r in range(b.n_in)}  # arena row -> SSA row
    n_rows = b.n_in
    for st in range(1, n_st + 1):
        free = sorted(a for a, r in holder.items() if last[r] < st)
        for a in free:
            del holder[a]
        for j in order:
            kind, r, ops = b.jobs[j]
            if level[r] != st:
                continue
            a = free.pop(0) if free else n_rows
            n_rows = max(n_rows, a + 1)
            where[r] = a
            holder[a] = r
    terms = []

    def put(lin: dict):
        if not lin or len(lin) > MAX_TERMS:
            raise ValueError(f"operand of {len(lin)} terms")
        off = len(terms)
        for x, c in sorted(lin.items()):
            if not -128 <= c <= 127:
                raise ValueError(f"coefficient {c} out of int8")
            terms.append((where[x] << 8) | (c & 0xFF))
        return off, len(lin)

    jobs, starts = [], []
    for j in order:
        kind, r, ops = b.jobs[j]
        while len(starts) < level[r]:
            starts.append(len(jobs))
        placed = [put(op) for op in ops]  # operand B's terms follow A's
        na, nb = placed[0][1], (placed[1][1] if len(placed) > 1 else 0)
        jobs.append((kind | (na << 8) | (nb << 16), where[r], placed[0][0]))
    starts.append(len(jobs))
    out_words = [put(o) for o in outs]
    n_fixed = H_STAGE0 + len(starts)
    t_base = n_fixed + JOB_WORDS * len(jobs) + OUT_WORDS * len(outs)
    words = [n_st, len(jobs), n_rows, len(outs), b.n_in, *starts]
    for w0, out, off in jobs:
        words += [w0, out, t_base + off]
    for off, n in out_words:
        words += [t_base + off, n]
    words += terms
    if len(words) > MAX_WORDS:
        raise ValueError(f"program of {len(words)} words > {MAX_WORDS}")
    return np.asarray(words, dtype=np.int64).astype(np.int32)


@functools.cache
def program(slot: int) -> np.ndarray:
    """The encoded program of PROGRAMS[slot] (int32 words, C order)."""
    body, fields = {
        # f, XT, YT, ZT, xP, yP -> f, X3, Y3, Z3
        "miller_dbl_iter": (pairing._dbl_iter_body, (FP12, FP2, FP2, FP2, FP, FP)),
        # f -> f^2
        "cyc_sqr": (pairing._cyc_sqr_body, (FP12,)),
        # X, Y, Z -> X3, Y3, Z3
        "jac_dbl_f2": (jacobian._dbl_f2_body, (FP2,) * 3),
        # acc, E (a point each) -> [4]acc, [4]acc + E (no selection)
        "g2_win_step": (chains._win_core_f2, (FP2,) * 6),
        # a, b -> a b
        "f12mul": (tower._f12mul_body, (FP12, FP12)),
        # a, 1 -> a^(p-2): the 1 is a row the kernel writes, not an operand
        "inv_w4": (chains._inv_w4_body, (FP, FP)),
        "inv_bin": (fp._inv_bin_body, (FP, FP)),
        # P1, P2 -> P1 + P2 (no selection)
        "jac_add_f2": (jacobian._add_core_f2, (FP2,) * 6),
        # the same over Fp (G1)
        "jac_dbl_f1": (jacobian._dbl_f1_body, (FP,) * 3),
        "jac_add_f1": (jacobian._add_core_f1, (FP,) * 6),
        # acc, E -> [4]acc, [4]acc + E (no selection)
        "g1_win_step": (chains._win_core_f1, (FP,) * 6),
        # w, 1 -> the ratio chain's 16 entries; acc, E -> acc^4 E
        "ratio_table": (htc._ratio_table_body, (FP2, FP2)),
        "ratio_win": (htc._ratio_win_body, (FP2, FP2)),
        # f, XT, YT, ZT, xQ, yQ, xP, yP -> f, X3, Y3, Z3
        "miller_add_iter": (pairing._add_iter_body, (FP12, FP2, FP2, FP2, FP2, FP2, FP, FP)),
        # a, b -> a b
        "f2mul": (tower._f2mul_body, (FP2, FP2)),
        # a -> a^2
        "f2sqr": (tower._f2sqr_body, (FP2,)),
        # P1, P2 -> P1 + P2, [2]P1, H, R (no selection)
        "add_exact_f1": (jacobian._add_exact_core_f1, (FP,) * 6),
        # a, b -> a b over Fp6 and over Fp
        "f6mul": (tower._f6mul_body, (FP6, FP6)),
        "mul": (fp._mul_fn, (FP, FP)),
        # a -> a^2 over Fp: one SQR job (fp._sqr_fn, looked up when traced)
        "sqr": (lambda folds, topf, a: fp._sqr_fn(folds, topf, a), (FP,)),
        # a -> a^2 over Fp12
        "f12sqr": (tower._f12sqr_body, (FP12,)),
        # f, c0, c1, c4 -> f (c0 + c1 v + c4 v w)
        "f12mul_034": (tower._f12mul_034_body, (FP12, FP2, FP2, FP2)),
    }[PROGRAMS[slot][0]]
    return np.ascontiguousarray(encode(*trace(body, fields)))


def slot(name: str) -> int:
    """The program slot of kernel `name` (of a chain or ladder kernel: its
    first program's)."""
    name = programs_of(name)[0]
    return next(k for k, (n, _) in PROGRAMS.items() if n == name)


def programs_of(name: str) -> tuple:
    """The programs kernel `name` runs."""
    if name in LADDERS:
        return LADDERS[name][0]
    return CHAINS.get(name, (name,))


def stats(slot: int, nw: int | None = None) -> dict:
    """Stages, jobs, rows and the shared memory of one block (bytes) of
    the program in `slot` on `nw` warps (default: its own); a PER_WARP
    kernel's block holds rows for each of its warps, each of which runs
    every job (its rounds)."""
    w = program(slot)
    n_st, n_jobs, n_rows = int(w[H_STAGES]), int(w[H_JOBS]), int(w[H_ROWS])
    name, own = PROGRAMS[slot]
    nw = own if nw is None else nw
    starts = w[H_STAGE0 : H_STAGE0 + n_st + 1]
    per_stage = np.diff(starts)
    jobs = w[H_STAGE0 + n_st + 1 :][: JOB_WORDS * n_jobs].reshape(-1, JOB_WORDS)
    per_warp = name in PER_WARP
    return dict(
        stages=n_st, jobs=n_jobs, rows=n_rows, warps=nw,
        products=int((jobs[:, 0] & 0xFF != RL).sum()),
        rounds=n_jobs if per_warp else int(sum(-(-int(n) // nw) for n in per_stage)),
        smem_bytes=4 * (TABLES + nw * SCRATCH + (nw if per_warp else 1) * n_rows * W),
        words=len(w),
    )


def kernel_stats(name: str) -> dict:
    """`stats` of kernel `name`: its program's; a ladder step's over its
    two programs on its own warps, both run (a bit set), on the rows of
    the larger; or the ratio chain's over its table run and its window
    runs, on the rows of both programs and the entries."""
    if name in LADDERS:
        progs, nw = LADDERS[name]
        parts = [stats(slot(p), nw) for p in progs]
        rows = max(p["rows"] for p in parts)
        return dict(**{k: sum(p[k] for p in parts)
                       for k in ("stages", "jobs", "products", "rounds", "words")},
                    rows=rows, warps=nw, smem_bytes=4 * (TABLES + nw * SCRATCH + rows * W))
    if name not in CHAINS:
        return stats(slot(name))
    table, win = (stats(slot(p)) for p in programs_of(name))
    n, nw = len(htc._WIN_IDX), table["warps"]
    rows = max(table["rows"], win["rows"] + int(program(slot(name))[H_OUTS]))
    return dict(
        stages=table["stages"] + n * win["stages"], jobs=table["jobs"] + n * win["jobs"],
        rows=rows, warps=nw, products=table["products"] + n * win["products"],
        rounds=table["rounds"] + n * win["rounds"],
        smem_bytes=4 * (TABLES + nw * SCRATCH + rows * W),
        words=table["words"] + win["words"] + n,
    )


def header() -> str:
    """The generated header the cooperative kernels include (kernels.build
    writes it into the build directory): per program, its slot, warps per
    lane element, rows, inputs and outputs as constexprs and its words as
    a `__constant__` array; per ladder step, its warps."""
    digits = [int(d) for d in htc._WIN_IDX]
    words = sum(len(program(slot)) for slot in PROGRAMS) + len(digits)
    if words + TABLES > BANK_WORDS:  # fp_lane.cuh's c_folds, c_topfm beside them
        raise ValueError(f"programs of {words} words overflow the constant bank")
    lines = ["// Generated from lighthouse_tpu_torch/ops/lane/coop.py; do not edit.",
             "#pragma once", "", "namespace lh {", "namespace coop {"]
    for slot, (name, nw) in sorted(PROGRAMS.items()):
        w, key = program(slot), name.upper()
        lines += ["", f"// {name}: " + ", ".join(f"{k} {v}" for k, v in stats(slot).items())]
        lines += [f"constexpr int {key}_SLOT = {slot};", f"constexpr int {key}_WARPS = {nw};"]
        lines += [f"constexpr int {key}_{part} = {int(w[at])};"
                  for part, at in (("ROWS", H_ROWS), ("INS", H_INS), ("OUTS", H_OUTS))]
        lines.append(f"static __constant__ int c_prog_{name}[{len(w)}] = {{")
        lines += ["    " + ", ".join(map(str, w[i : i + 12].tolist())) + ","
                  for i in range(0, len(w), 12)]
        lines.append("};")
    # the ladder steps' warps (csrc/ladder.cu), beside their programs' own
    for name, (progs, nw) in sorted(LADDERS.items()):
        lines += ["", f"// {name}: " + ", then ".join(progs),
                  f"constexpr int {name.upper()}_WARPS = {nw};"]
    # the ratio chain's window digits (csrc/htc.cu), most significant first
    lines += ["", f"constexpr int RATIO_WINDOWS = {len(digits)};",
              f"static __constant__ int c_ratio_idx[{len(digits)}] = {{"]
    lines += ["    " + ", ".join(map(str, digits[i : i + 24])) + ","
              for i in range(0, len(digits), 24)]
    lines += ["};", "", "}  // namespace coop", "}  // namespace lh", ""]
    return "\n".join(lines)


# ------------------------------------------------------------ reference


def run_reference(words: np.ndarray, inputs, folds, topf):
    """Execute an encoded program on CPU tensors: `inputs` the input rows
    [n_in, W, S] int32; returns the output rows [n_out, W, S]. Every job
    runs its plain Fp body (fp._mul_body, fp._sqr_fn, fp._reduce_light_body); a stage
    that writes a row it also reads, or writes one row twice, raises."""
    w = [int(v) for v in words]
    n_st, n_rows, n_out, n_in = w[H_STAGES], w[H_ROWS], w[H_OUTS], w[H_INS]
    starts = w[H_STAGE0 : H_STAGE0 + n_st + 1]
    j_base = H_STAGE0 + n_st + 1
    arena = torch.zeros((n_rows, W, inputs.shape[-1]), dtype=torch.int32)
    arena[:n_in] = inputs

    def terms(off, n):
        return [(t >> 8, ((t & 0xFF) ^ 0x80) - 0x80) for t in w[off : off + n]]

    def value(ts):
        acc = torch.zeros_like(arena[0], dtype=torch.int64)
        for row, c in ts:
            acc += c * arena[row].long()
        return acc.to(torch.int32)

    for st in range(n_st):
        reads, writes, results = set(), [], []
        for j in range(starts[st], starts[st + 1]):
            w0, out, off = w[j_base + JOB_WORDS * j : j_base + JOB_WORDS * (j + 1)]
            kind, na, nb = w0 & 0xFF, (w0 >> 8) & 0xFF, (w0 >> 16) & 0xFF
            ta, tb = terms(off, na), terms(off + na, nb)
            reads.update(r for r, _ in ta + tb)
            writes.append(out)
            if kind == MUL:
                v = fp._mul_body(value(ta), value(tb), folds, topf)
            elif kind == SQR:
                v = fp._sqr_fn(folds, topf, value(ta))
            else:
                v = fp._reduce_light_body(value(ta), folds, topf)
            results.append((out, v))
        if len(set(writes)) != len(writes) or reads & set(writes):
            raise AssertionError(f"stage {st}: a row written twice or read and written")
        for out, v in results:
            arena[out] = v
    o_base = j_base + JOB_WORDS * starts[-1]
    return torch.stack([
        value(terms(*w[o_base + OUT_WORDS * o : o_base + OUT_WORDS * (o + 1)]))
        for o in range(n_out)
    ])
