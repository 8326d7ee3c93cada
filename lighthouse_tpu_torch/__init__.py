"""lighthouse_tpu_torch: the PyTorch/CUDA port of lighthouse_tpu.

A package of its own beside the JAX reference, with the reference's module
paths. It imports torch, never jax, and nothing of lighthouse_tpu: what it
needs of the reference's jax-free modules it keeps as its own copies.
Entry points run on CUDA unless the caller passes device="cpu".

Ported so far: the main path, BLS batch signature verification
(crypto/bls `verify_signature_sets`, backend "cuda": hash-to-G2, the G1/G2
windowed ladders, subgroup checks, Miller loops and the final
exponentiation on the device), and the KZG blob commit / prove /
batch-verify path with the G1 MSM and the pairing check on the device
(crypto/kzg/device.py `device_kzg`), over the lane-major Fp core and tower
(ops/lane/fp.py, tower.py), the G1/G2 Jacobian ops with the per-lane
ladders and the windowed chains (jacobian.py, chains.py), the map to G2
(htc.py) and the pairing (pairing.py), whose kernels are hand-written CUDA
for sm_90a (csrc/): every TPU kernel of the reference has one, the
Fp-product microbenchmark's (tools/ubench_mul.py) included.
"""
