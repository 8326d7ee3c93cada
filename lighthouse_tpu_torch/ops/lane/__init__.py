"""Lane-major [..., W, S] field and group ops with hand-written CUDA kernels."""
