"""BLS12-381 curve parameters (the port's own copy of
lighthouse_tpu/crypto/bls/params.py; pure ints).

All constants below are standard public parameters of the BLS12-381 curve
(the curve used by Ethereum consensus; the reference binds them via the blst
library, crypto/bls/src/impls/blst.rs). They were self-verified in-tree by
algebraic identity:

    r == x^4 - x^2 + 1
    p == ((x - 1)^2 * r) // 3 + x
    G1 on  y^2 = x^3 + 4         over Fp
    G2 on  y^2 = x^3 + 4(1 + u)  over Fp2 = Fp[u]/(u^2 + 1)
    #E(Fp) == h1 * r == p + 1 - t,  t = x + 1

(see tests/test_bls_ref.py::test_params_identities).
"""

# BLS parameter (the "x" of the BLS12 family). Negative.
X = -0xD201000000010000

# Base field prime (381 bits).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Subgroup order (255 bits) — the scalar field.
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# Curve coefficients: E1: y^2 = x^3 + B ; E2 (M-twist): y^2 = x^3 + B*(1+u)
B = 4

# Cofactors.
H1 = (X - 1) ** 2 // 3  # = 0x396C8C005555E1568C00AAAB0000AAAB
H2 = (X**8 - 4 * X**7 + 5 * X**6 - 4 * X**4 + 6 * X**3 - 4 * X**2 - 4 * X + 13) // 9

# Effective cofactor for G2 cofactor clearing per RFC 9380 §8.8.2 style
# (h_eff = h2 * (3 * z^2 - 3) ... implementations commonly use the
# Budroni–Pintore psi-based fast clearing instead; see hash_to_curve.py).

# G1 generator (standard).
G1X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

# G2 generator (standard). Fp2 elements are (c0, c1) meaning c0 + c1*u.
G2X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# Domain separation tag for Ethereum consensus BLS signatures
# (proof-of-possession scheme; reference: crypto/bls/src/impls/blst.rs:15).
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# Number of random bits per batch-verification scalar
# (reference: crypto/bls/src/impls/blst.rs:16 RAND_BITS = 64).
RAND_BITS = 64

# Fp2 non-residue used to build the tower: Fp2 = Fp[u]/(u^2 + 1),
# Fp6 = Fp2[v]/(v^3 - XI), Fp12 = Fp6[w]/(w^2 - v), XI = 1 + u.
XI = (1, 1)


def lane_bucket(n: int) -> int:
    """Power-of-two lane buckets, minimum 128: the bucket ladder the
    device MSM pads its point batches to (ops/lane/msm.py)."""
    return 1 << max(7, (n - 1).bit_length())
