"""Cryptography of the port: BLS12-381 host arithmetic and KZG."""
