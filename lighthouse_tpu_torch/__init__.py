"""lighthouse_tpu_torch: the PyTorch/CUDA port of lighthouse_tpu.

A package of its own beside the JAX reference, with the reference's module
paths. It imports torch, never jax, and nothing of lighthouse_tpu: what it
needs of the reference's jax-free modules it keeps as its own copies.
Entry points run on CUDA unless the caller passes device="cpu".

Ported so far: the KZG blob commit / prove / batch-verify path with the G1
MSM on the GPU (crypto/kzg/device.py `device_kzg`), over the lane-major Fp
core (ops/lane/fp.py) and G1 Jacobian ops (ops/lane/jacobian.py), whose
kernels are hand-written CUDA for sm_90a (csrc/).
"""
