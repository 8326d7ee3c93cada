#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's KZG slice on one GPU and hold every kernel
against its plain PyTorch version.

Run from the repository root on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit (nvcc):

    python3 chip_smoke.py

It imports lighthouse_tpu_torch only (never jax or lighthouse_tpu) and
needs one card. Phases, one line each; any failure raises and exits
non-zero before the last line:

1. card: the `nvidia-smi --query-gpu=name,power.limit` line.
2. build: the four CUDA libraries from csrc/ (one nvcc each, in parallel),
   with ptxas' registers / spill bytes per kernel.
3. kernels: each kernel (mul, sqr, canon_reduce, jac_dbl_f1, jac_add_f1)
   against its plain body on the card, torch.equal, at [36,4096],
   [2,36,128] and [36,4097]; median time (CUDA events) at [36,4096] beside
   its bound and the plain body's time; the ripple glue of canonical();
   a small MSM against the host group law.
4. e2e: the mainnet setup; the fixture blob's commitment and proof equal
   to c-kzg's bytes; 5 more seeded blobs committed and proved (a Deneb
   block's 6); the batch verifies, and fails with one byte flipped. The
   launch counters are zeroed just before and read just after; one
   commitment's MSM is profiled for its device share.
5. the `kernels` JSON line; 6. the `ok` JSON line (last).
"""

from __future__ import annotations

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

KERNELS = {
    # name: (source, replaced Pallas kernel, inputs, outputs)
    "mul": ("lighthouse_tpu_torch/csrc/fp_mul.cu", "lighthouse_tpu/ops/lane/fp.py:440", 2, 1),
    "sqr": ("lighthouse_tpu_torch/csrc/fp_mul.cu", "lighthouse_tpu/ops/lane/fp.py:441", 1, 1),
    "canon_reduce": ("lighthouse_tpu_torch/csrc/fp_canon.cu", "lighthouse_tpu/ops/lane/fp.py:444", 1, 1),
    "jac_dbl_f1": ("lighthouse_tpu_torch/csrc/jac_dbl.cu", "lighthouse_tpu/ops/lane/jacobian.py:163", 3, 3),
    "jac_add_f1": ("lighthouse_tpu_torch/csrc/jac_add.cu", "lighthouse_tpu/ops/lane/jacobian.py:165", 6, 3),
}
# launches per msm_g1 at a 4096-lane bucket, read off the code
PER_MSM = {"jac_add_f1": 90, "sqr": 180, "mul": 540, "canon_reduce": 180, "jac_dbl_f1": 346}


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


# ------------------------------------------------------------ work counts
# int32 operations per element, counted from the bodies (ops/lane/fp.py,
# jacobian.py): a carry pass is 5 ops a limb (shift, mask, carry add and
# the topfold multiply-add), an open pass 3; a multiply-add is 2.


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
    lazy = W  # one limb-wise add / sub / small multiple
    dbl = 5 * sqr + 2 * mul + 3 * rl + 14 * lazy
    add = 5 * sqr + 11 * mul + 4 * rl + 16 * lazy + 3 * W + 2 * W  # + selects, Z tests
    return {"mul": mul, "sqr": sqr, "canon_reduce": canon, "jac_dbl_f1": dbl, "jac_add_f1": add}


def bound_ms(name: str, n_elems: int) -> tuple:
    _, _, n_in, n_out = KERNELS[name]
    t_bytes = (n_in + n_out) * 36 * 4 * n_elems / PEAK_BYTES_S
    t_ops = _ops_counts()[name] * n_elems / PEAK_INT32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


# ---------------------------------------------------------------- phases


def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build() -> None:
    from lighthouse_tpu_torch.ops.lane import kernels

    t0 = time.perf_counter()
    kernels.libs()
    info = kernels.BUILD_INFO
    say("build", seconds=f"{time.perf_counter() - t0:.1f}",
        nvcc_seconds=f"{info.get('seconds', 0.0):.1f}",
        built=",".join(info.get("built", [])) or "cached")
    # ptxas -v: registers, stack frame and spill bytes of each function
    for lib, log in sorted(info.get("logs", {}).items()):
        fn = None
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w]+)", line)
            if m:
                fn = m.group(1)
                continue
            if fn and ("registers" in line or "spill" in line):
                short = re.search(r"(k_[a-z][a-z0-9_]*?|fp_[a-z_]+?)(?:ILb|E|PK|Pi|ii|$)", fn)
                print(f"  ptxas {lib} {short.group(1) if short else fn}"
                      f": {line.split(':', 1)[-1].strip()}",
                      flush=True)


def _inputs(rng, shape, kind):
    """Seeded lazy operands inside the certified intervals."""
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
    if kind == "sqr":
        return [t(lazy3())]
    if kind == "canon_reduce":  # eq_zero's operand: a difference of products
        return [t(canon() - canon())]
    pts = [t(canon()), t(lazy3()), t(canon())]
    lanes = torch.arange(S, device=dev)
    pts[2][..., lanes % 7 == 3] = 0  # structural infinity (Z = 0) lanes
    if kind == "jac_dbl_f1":
        return pts
    other = [t(canon()), t(canon()), t(lazy3())]
    other[2][..., lanes % 5 == 1] = 0
    other[2][..., lanes % 7 == 3] = 0  # both infinity on some lanes
    return pts + other


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


# each kernel's symbol in the profiler's trace
TRACE_NAMES = {
    "mul": r"\bk_mul\b",
    "sqr": r"\bk_sqr\b",
    "canon_reduce": r"k_canon_reduce",
    "jac_dbl_f1": r"k_jac_dbl_f1",
    "jac_add_f1": r"k_jac_add_f1",
}


def _kernel_ms(name: str, fn, reps: int = 20) -> tuple:
    """One launch's device time, from the profiler's trace of `reps`
    launches (the host's launch overhead excluded). Where the trace holds
    no device time for the kernel, the CUDA-event median of a whole call
    stands in, and the second value says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if re.search(TRACE_NAMES[name], e.key) and _device_time(e) > 0]
    if not hits:
        return _median_ms(fn), "events"
    return sum(_device_time(e) for e in hits) / sum(e.count for e in hits) / 1e3, "profiler"


def phase_kernels() -> dict:
    from lighthouse_tpu_torch.crypto.bls import curve as C
    from lighthouse_tpu_torch.crypto.bls.params import G1X, G1Y
    from lighthouse_tpu_torch.crypto.kzg import _msm_host
    from lighthouse_tpu_torch.ops.lane import fp, jacobian as J, msm

    ops = {"mul": fp.mul, "sqr": fp.sqr, "canon_reduce": fp.canon_reduce,
           "jac_dbl_f1": J._dbl_f1, "jac_add_f1": J._add_f1}
    rng = np.random.default_rng(SEED)
    out = {}
    for name, op in ops.items():
        max_err = 0
        for shape in SHAPES:
            args = _inputs(rng, shape, name)
            got = op(*args)
            want = op.plain(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                if g.shape != w.shape or g.dtype != w.dtype:
                    raise AssertionError(f"{name} {shape}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
                max_err = max(max_err, int((g.long() - w.long()).abs().max()))
                if not torch.equal(g, w):
                    raise AssertionError(f"{name} {shape}: kernel != plain body (max |diff| {max_err})")
            if shape == SHAPES[0]:
                ms, timed_by = _kernel_ms(name, lambda: op(*args))
                call_ms = _median_ms(lambda: op(*args))
                plain_ms = _median_ms(lambda: op.plain(*args), reps=5, warm=1)
        b_ms, b_by = bound_ms(name, 4096)
        out[name] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, call_ms=call_ms)
        say("kernel", name=name, equal="yes", tolerance="exact(torch.equal)",
            shapes="36x4096,2x36x128,36x4097",
            ms=f"{ms:.4f}", timed_by=timed_by, call_ms=f"{call_ms:.4f}",
            bound_ms=f"{b_ms:.5f}", bound_by=b_by, plain_ms=f"{plain_ms:.3f}")

    # canonical(): one canon_reduce launch + the ripple glue (8 ripples of
    # 37 small torch ops), timed apart at the path's width
    x = _inputs(rng, (36, 4096), "canon_reduce")[0]
    canon_ms = _median_ms(lambda: fp.canonical(x), reps=10)
    glue_ms = canon_ms - out["canon_reduce"]["call_ms"]
    out["_glue"] = dict(canonical_ms=canon_ms, ripple_glue_ms=glue_ms)
    say("glue", canonical_ms=f"{canon_ms:.3f}", ripple_glue_ms=f"{glue_ms:.3f}",
        per_msm_ms=f"{glue_ms * 180:.1f}")

    # a small input against the host group law (the port's _msm_host)
    G = (G1X, G1Y)
    pts = [C.g1_mul(G, k) for k in (3, 5, 7)] + [None]
    sc = [0x1234_5678_9ABC_DEF0, 5, 0, 2**254 + 3]
    got = msm.msm_g1(pts, sc, device=DEVICE)
    if got != _msm_host(pts, sc):
        raise AssertionError("msm_g1 on the card disagrees with the host MSM")
    say("kernel", small_msm="equal to host group law", points=4)
    return out


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


def _device_share(fn, wall_s: float) -> str:
    """Device (kernel) time of one call, from the profiler's trace, over
    the same call's wall time measured without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_us = sum(_device_time(e) for e in events)
    if dev_us <= 0:
        return "not_measured(no device time in the profiler trace)"
    top = sorted(events, key=lambda e: -_device_time(e))[:5]
    names = ",".join(f"{e.key[:28]}:{_device_time(e) / 1e3:.2f}ms" for e in top)
    return (f"{dev_us / 1e6 / wall_s:.4f} device_ms={dev_us / 1e3:.2f} "
            f"wall_ms={wall_s * 1e3:.1f} top={names}")


def phase_e2e() -> dict:
    from lighthouse_tpu_torch.crypto.bls import curve as C
    from lighthouse_tpu_torch.crypto.bls.params import R
    from lighthouse_tpu_torch.crypto.kzg import TrustedSetup
    from lighthouse_tpu_torch.crypto.kzg.device import device_kzg
    from lighthouse_tpu_torch.ops.lane import fp

    t0 = time.perf_counter()
    setup = TrustedSetup.mainnet()
    say("e2e", setup="mainnet", points=len(setup.g1_lagrange), load_s=f"{time.perf_counter() - t0:.2f}")
    kzg = device_kzg(setup, device=DEVICE)
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
            per_msm = {k: fp.LAUNCHES[k] - before.get(k, 0) for k in KERNELS}
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
    bad = bytearray(blobs[0])
    bad[5000] ^= 1
    t = time.perf_counter()
    ok_bad = kzg.verify_blob_kzg_proof_batch([bytes(bad)] + blobs[1:], cs, ps)
    verify_bad_s = time.perf_counter() - t
    if ok_bad is not False:
        raise AssertionError("a corrupted blob verified")
    torch.cuda.synchronize()
    launches = dict(fp.LAUNCHES)  # ---- ... and ends here
    plain_calls = dict(fp.PLAIN_CUDA_CALLS)
    say("e2e", blobs=len(blobs), batch_verify="True", corrupted_verify="False",
        commit_s=f"{statistics.median(walls['commit']):.3f}",
        prove_s=f"{statistics.median(walls['prove']):.3f}",
        verify_batch_s=f"{verify_s:.3f}", verify_corrupted_s=f"{verify_bad_s:.3f}")
    if per_msm != PER_MSM:
        raise AssertionError(f"launches per 4096-lane MSM {per_msm}, expected {PER_MSM}")
    say("e2e", launches_per_msm=json.dumps(per_msm, separators=(",", ":")))
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if plain_calls:
        raise AssertionError(f"plain bodies ran on CUDA tensors on the main path: {plain_calls}")
    share = _device_share(
        lambda: kzg.blob_to_kzg_commitment(blobs[1]), statistics.median(walls["commit"])
    )
    say("e2e", msm_device_share=share)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import lighthouse_tpu_torch  # noqa: F401  (fails outside the repository)

    card = phase_card()
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), card=repr(card))
    phase_build()
    per_kernel = phase_kernels()
    launches = phase_e2e()
    rows = []
    for name, (src, replaces, _, _) in KERNELS.items():
        k = per_kernel[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
