"""Tools of the port: the Fp-product microbenchmark (ubench_mul)."""
