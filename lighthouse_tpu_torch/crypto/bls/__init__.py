"""BLS12-381 host arithmetic (copies of the reference's jax-free modules)."""
