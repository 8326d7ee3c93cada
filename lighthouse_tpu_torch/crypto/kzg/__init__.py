"""KZG polynomial commitments for EIP-4844 blobs: the port's `Kzg`.

Port of lighthouse_tpu/crypto/kzg/__init__.py (host code: Fr arithmetic,
the evaluation domain, the trusted setup and the Fiat-Shamir batch check,
with the same `msm` / `msm_multi` / `pairing` seams). `device.py` wires the
lane-major CUDA MSM into the seams; the pairing stays the host default.

The reference wraps c-kzg (C) behind `Kzg` with batch entry points
(crypto/kzg/src/lib.rs:50-54,156-183). Here the same surface is
implemented natively: Fr arithmetic and the bit-reversed roots-of-unity
evaluation domain on the host, commitments/proofs over the Lagrange-form
trusted setup, and the Fiat-Shamir batch check

    e(sum r^i (C_i - [y_i]G1) + sum r^i z_i P_i, G2)
      * e(-sum r^i P_i, [tau]G2) == 1

which reduces any number of blob proofs to ONE MSM + two pairings —
the same kernel family as BLS batch verification (SURVEY.md §2.7 item
2). The G1 MSM over the 4096-element blob is the device-offloadable
hot op (ops/msm.py); pairings use the validated host pairing.

Trusted setup: `TrustedSetup.dev(n)` derives an INSECURE deterministic
setup from a fixed tau (for tests/benchmarks — tau is public!);
`TrustedSetup.from_json` loads a real ceremony file when provided, and
`TrustedSetup.mainnet()` the ceremony file the reference package ships.

p(z) is evaluated by the pure-Python barycentric formula; the reference's
native C++ Fr engine (lighthouse_tpu/crypto/kzg/_fr_native.py) is not
ported yet.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from pathlib import Path

import torch

from ...ops.lane import jacobian as J
from ..bls import curve as C
from ..bls import fields as FF
from ..bls import pairing_fast as PF
from ..bls.params import P, R, G1X, G1Y, G2X, G2Y

FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_BLOB = FIELD_ELEMENTS_PER_BLOB * BYTES_PER_FIELD_ELEMENT

# Fr: the BLS12-381 scalar field. 2-adicity 32, generator 7.
_PRIMITIVE_ROOT = 7
_MAINNET_SETUP = None

_REPO = Path(__file__).resolve().parents[3]
# the ceremony file, read as data where the reference package keeps it
MAINNET_JSON = _REPO / "lighthouse_tpu" / "crypto" / "kzg" / "trusted_setup_mainnet.json"
# decompressed-point cache, in the port's (gitignored) build directory
MAINNET_CACHE = _REPO / "lighthouse_tpu_torch" / "build" / "trusted_setup_mainnet.cache.pkl"

FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_DOMAIN = b"RCKZGBATCH___V1_"

G1_GEN = (G1X, G1Y)
G2_GEN = (G2X, G2Y)


class KzgError(Exception):
    pass


# ---------------------------------------------------------------- Fr / domain


def _bit_reverse(n: int, order: int) -> int:
    bits = order.bit_length() - 1
    out = 0
    for i in range(bits):
        out |= ((n >> i) & 1) << (bits - 1 - i)
    return out


def compute_roots_of_unity(order: int) -> list:
    """Bit-reversal-permuted roots of unity for the evaluation domain
    (the layout c-kzg uses in memory)."""
    assert order & (order - 1) == 0
    w = pow(_PRIMITIVE_ROOT, (R - 1) // order, R)
    roots = [pow(w, i, R) for i in range(order)]
    return [roots[_bit_reverse(i, order)] for i in range(order)]


def bit_reversal_permutation(values: list) -> list:
    """c-kzg's load-time brp: ceremony files ship g1_lagrange in NATURAL
    domain order; the in-memory basis must match the brp evaluation
    domain, or commitments disagree with c-kzg's (the fixture blob of
    tests/vectors/external/test_blobs_bundle.ssz pins this)."""
    n = len(values)
    assert n & (n - 1) == 0
    return [values[_bit_reverse(i, n)] for i in range(n)]


def bytes_to_fr(b: bytes) -> int:
    x = int.from_bytes(b, "big")
    if x >= R:
        raise KzgError("scalar not canonical")
    return x


def fr_to_bytes(x: int) -> bytes:
    return (x % R).to_bytes(32, "big")


def blob_to_field_elements(blob: bytes, n: int = FIELD_ELEMENTS_PER_BLOB) -> list:
    if len(blob) != n * BYTES_PER_FIELD_ELEMENT:
        raise KzgError("bad blob length")
    return [bytes_to_fr(blob[i * 32 : (i + 1) * 32]) for i in range(n)]


def fr_batch_inverse(xs: list) -> list:
    """Montgomery batch inversion: ONE Fermat pow for any number of
    nonzero elements (zero maps to zero)."""
    prefix = []
    acc = 1
    for x in xs:
        prefix.append(acc)
        if x % R:
            acc = acc * x % R
    inv = pow(acc, R - 2, R)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        if xs[i] % R == 0:
            continue
        out[i] = inv * prefix[i] % R
        inv = inv * xs[i] % R
    return out


# ---------------------------------------------------------------- setup


@dataclass
class TrustedSetup:
    g1_lagrange: list          # [L_i(tau)]G1, bit-reversed domain order
    g2_tau: tuple              # [tau]G2
    roots: list                # domain, bit-reversed order
    # monomial powers — required only by the PeerDAS cell ops
    # (coefficient-form quotient proofs); None for Lagrange-only setups
    g1_monomial: list = None   # [[tau^i]G1]
    g2_monomial: list = None   # [[tau^i]G2] (up to cell size + 1)
    # packed g1_lagrange per device (see g1_basis)
    _basis: dict = field(default_factory=dict, repr=False, compare=False)

    def g1_basis(self, device) -> tuple:
        """g1_lagrange packed once per device: (X, Y, Z) [W, n] int32."""
        dev = torch.device(device)
        if dev not in self._basis:
            self._basis[dev] = J.pack_g1(self.g1_lagrange, dev)
        return self._basis[dev]

    @classmethod
    def mainnet(cls) -> "TrustedSetup":
        """The REAL KZG ceremony output (4096 Lagrange G1 points + G2
        monomials) from the ceremony file the reference package ships.
        Points are decompressed without subgroup checks (ceremony-
        validated); the 4096 G1 decompressions cost seconds of host math,
        so they are cached in-process and on disk (MAINNET_CACHE, keyed by
        the file's size and mtime). The G1 monomial powers serve only the
        PeerDAS cell ops, which are not ported: g1_monomial stays None."""
        global _MAINNET_SETUP
        if _MAINNET_SETUP is None:
            import json as _json
            import pickle as _pickle

            st_ = MAINNET_JSON.stat()
            want_key = (1, st_.st_size, int(st_.st_mtime))
            g1l = g2m = None
            if MAINNET_CACHE.exists():
                key, g1l, g2m = _pickle.loads(MAINNET_CACHE.read_bytes())
                if tuple(key) != want_key:
                    g1l = g2m = None  # the json changed: decompress again
            if g1l is None:
                raw = _json.loads(MAINNET_JSON.read_text())
                g1l = bit_reversal_permutation(
                    [
                        C.g1_decompress(bytes.fromhex(h[2:]), subgroup_check=False)
                        for h in raw["g1_lagrange"]
                    ]
                )
                g2m = [
                    C.g2_decompress(bytes.fromhex(h[2:]), subgroup_check=False)
                    for h in raw["g2_monomial"]
                ]
                MAINNET_CACHE.parent.mkdir(parents=True, exist_ok=True)
                MAINNET_CACHE.write_bytes(_pickle.dumps((want_key, g1l, g2m)))
            _MAINNET_SETUP = cls(
                g1_lagrange=g1l,
                g2_tau=g2m[1],
                roots=compute_roots_of_unity(len(g1l)),
                g2_monomial=g2m,
            )
        return _MAINNET_SETUP

    @classmethod
    def dev(cls, n: int = FIELD_ELEMENTS_PER_BLOB, with_monomial=None) -> "TrustedSetup":
        """Deterministic INSECURE setup: tau is derived from a public
        seed, so proofs can be forged — dev/test/bench only."""
        tau = (
            int.from_bytes(
                hashlib.sha256(b"lighthouse-tpu insecure dev tau").digest(),
                "big",
            )
            % R
        )
        roots = compute_roots_of_unity(n)
        n_inv = pow(n, R - 2, R)
        zn = (pow(tau, n, R) - 1) % R
        g1s = []
        for w in roots:
            if tau == w:
                li = 1  # degenerate (never for a hash-derived tau)
            else:
                li = (
                    w
                    * n_inv
                    % R
                    * zn
                    % R
                    * pow((tau - w) % R, R - 2, R)
                    % R
                )
            g1s.append(C.g1_mul(G1_GEN, li))
        # monomial powers for the PeerDAS cell ops (dev setup knows
        # tau). Host G1 muls are ~0.5s each in pure Python, so large
        # setups skip them unless asked — blob commit/verify paths
        # only need the Lagrange basis.
        if with_monomial is None:
            with_monomial = n <= 512
        g1m = g2m = None
        if with_monomial:
            g1m, acc = [], 1
            for _ in range(n):
                g1m.append(C.g1_mul(G1_GEN, acc))
                acc = acc * tau % R
            g2m, acc = [], 1
            for _ in range(min(n, 65) + 1):
                g2m.append(C.g2_mul(G2_GEN, acc))
                acc = acc * tau % R
        return cls(
            g1_lagrange=g1s,
            g2_tau=C.g2_mul(G2_GEN, tau),
            roots=roots,
            g1_monomial=g1m,
            g2_monomial=g2m,
        )

    @classmethod
    def from_json(cls, obj: dict) -> "TrustedSetup":
        """Load a ceremony file (the standard trusted_setup.json shape:
        g1_lagrange / g2_monomial hex point lists; lagrange points are
        brp'd into the in-memory domain order like c-kzg's loader)."""
        g1s = bit_reversal_permutation(
            [
                C.g1_decompress(
                    bytes.fromhex(h[2:] if h.startswith("0x") else h)
                )
                for h in obj["g1_lagrange"]
            ]
        )
        def _pt2(h):
            return C.g2_decompress(
                bytes.fromhex(h[2:] if h.startswith("0x") else h)
            )

        g2s = obj["g2_monomial"]
        g2_tau = _pt2(g2s[1])
        g1m = None
        if "g1_monomial" in obj:
            g1m = [
                C.g1_decompress(
                    bytes.fromhex(h[2:] if h.startswith("0x") else h)
                )
                for h in obj["g1_monomial"]
            ]
        return cls(
            g1_lagrange=g1s,
            g2_tau=g2_tau,
            roots=compute_roots_of_unity(len(g1s)),
            g1_monomial=g1m,
            g2_monomial=[_pt2(h) for h in g2s],
        )


# ---------------------------------------------------------------- core


def _msm_host(points: list, scalars: list):
    """Host MSM control path; ops/lane/msm.py is the device path."""
    acc = None
    for p, s in zip(points, scalars):
        if s == 0 or p is None:
            continue
        acc = C.g1_add(acc, C.g1_mul(p, s))
    return acc


class Kzg:
    """The reference's `Kzg` service object (crypto/kzg/src/lib.rs:50)."""

    def __init__(
        self, setup: TrustedSetup = None, msm=None, pairing=None, msm_multi=None
    ):
        self.setup = setup or TrustedSetup.dev()
        self.n = len(self.setup.g1_lagrange)
        self._msm = msm or _msm_host  # device seam: batched G1 MSM
        # optional segmented-MSM seam: fn(points, scalars, group_ids,
        # n_groups) -> [point | None]; one ladder walk for the batch
        # check's two sums (ops/lane/msm.py msm_g1_groups)
        self._msm_multi = msm_multi
        # device seam: pairing-product check ([(G1, G2)] -> bool);
        # host control = validated pure-Python pairing
        self._pairing = pairing or (
            lambda pairs: PF.pairings_product_is_one_fast(pairs)
        )

    # -- commitments

    def blob_to_kzg_commitment(self, blob: bytes):
        scalars = blob_to_field_elements(blob, self.n)
        return self._msm(self.setup.g1_lagrange, scalars)

    def commitment_bytes(self, commitment) -> bytes:
        return C.g1_compress(commitment)

    # -- evaluation

    def evaluate_polynomial(self, blob_fields: list, z: int) -> int:
        """p(z) from evaluation form via the barycentric formula (batch
        inversion: one Fermat pow for the whole domain)."""
        roots = self.setup.roots
        n = len(roots)
        for i, w in enumerate(roots):
            if z == w:
                return blob_fields[i]
        zn = (pow(z, n, R) - 1) % R
        n_inv = pow(n, R - 2, R)
        invs = fr_batch_inverse([(z - w) % R for w in roots])
        total = 0
        for fi, w, iv in zip(blob_fields, roots, invs):
            total = (total + fi * w % R * iv) % R
        return total * zn % R * n_inv % R

    # -- proofs

    def compute_kzg_proof(self, blob: bytes, z: int) -> tuple:
        """(proof point, y = p(z)). Quotient in evaluation form
        (c-kzg compute_kzg_proof_impl semantics), batch-inverted."""
        fields = blob_to_field_elements(blob, self.n)
        roots = self.setup.roots
        n = len(roots)
        y = self.evaluate_polynomial(fields, z)
        m = None
        for i, w in enumerate(roots):
            if z == w:
                m = i
        invs = fr_batch_inverse([(w - z) % R for w in roots])
        q = [0] * n
        for i, (w, iv) in enumerate(zip(roots, invs)):
            if i == m:
                continue
            q[i] = (fields[i] - y) % R * iv % R
        if m is not None:
            # z ON the domain: q_m = sum_{i!=m} (f_i - y) w_i /
            # (w_m (w_m - w_i))
            wm = roots[m]
            wm_inv = pow(wm, R - 2, R)
            dinvs = fr_batch_inverse(
                [(wm - w) % R if i != m else 1 for i, w in enumerate(roots)]
            )
            acc = 0
            for i, (w, div) in enumerate(zip(roots, dinvs)):
                if i == m:
                    continue
                qi = (fields[i] - y) % R * div % R
                acc = (acc + qi * w) % R
            q[m] = acc * wm_inv % R
        return self._msm(self.setup.g1_lagrange, q), y

    def compute_blob_kzg_proof(self, blob: bytes, commitment) -> tuple:
        z = self._blob_challenge(blob, commitment)
        return self.compute_kzg_proof(blob, z)

    # -- verification

    def verify_kzg_proof(self, commitment, z: int, y: int, proof) -> bool:
        """e(C - [y]G1, G2) == e(proof, [tau - z]G2), as the 2-pairing
        product check."""
        return self._pairing_batch([(commitment, z, y, proof)])

    def verify_blob_kzg_proof(self, blob: bytes, commitment, proof) -> bool:
        z = self._blob_challenge(blob, commitment)
        y = self._evaluate_blobs([blob], [z])[0]
        return self.verify_kzg_proof(commitment, z, y, proof)

    def verify_blob_kzg_proof_batch(
        self, blobs: list, commitments: list, proofs: list
    ) -> bool:
        """crypto/kzg/src/lib.rs:156-183 semantics: one combined check
        for the whole batch."""
        if not (len(blobs) == len(commitments) == len(proofs)):
            raise KzgError("length mismatch")
        if not blobs:
            return True
        zs = [
            self._blob_challenge(blob, cm)
            for blob, cm in zip(blobs, commitments)
        ]
        ys = self._evaluate_blobs(blobs, zs)
        items = [
            (cm, z, y, pr)
            for cm, z, y, pr in zip(commitments, zs, ys, proofs)
        ]
        return self._pairing_batch(items)

    def _evaluate_blobs(self, blobs: list, zs: list) -> list:
        """p_j(z_j) for each blob, pure-Python barycentric."""
        return [
            self.evaluate_polynomial(blob_to_field_elements(b, self.n), z)
            for b, z in zip(blobs, zs)
        ]

    # -- internals

    def _blob_challenge(self, blob: bytes, commitment) -> int:
        # KZG_ENDIANNESS is 'big' throughout the spec's Fiat-Shamir —
        # including the 16-byte polynomial degree. (Caught by the
        # external c-kzg fixture, tests/test_external_vectors.py.)
        h = hashlib.sha256(
            FIAT_SHAMIR_PROTOCOL_DOMAIN
            + self.n.to_bytes(16, "big")
            + blob
            + C.g1_compress(commitment)
        ).digest()
        return int.from_bytes(h, "big") % R

    def _batch_r_powers(self, items) -> list:
        # spec compute_r_powers transcript: domain | degree (16B big) |
        # count (8B big) | commitments | zs | ys | proofs. The value is
        # verifier-local (any RLC is sound), but keep the transcript
        # spec-exact like _blob_challenge.
        data = (
            RANDOM_CHALLENGE_DOMAIN
            + self.n.to_bytes(16, "big")
            + len(items).to_bytes(8, "big")
        )
        data += b"".join(C.g1_compress(cm) for cm, _, _, _ in items)
        data += b"".join(fr_to_bytes(z) for _, z, _, _ in items)
        data += b"".join(fr_to_bytes(y) for _, _, y, _ in items)
        data += b"".join(C.g1_compress(pr) for _, _, _, pr in items)
        r = int.from_bytes(hashlib.sha256(data).digest(), "big") % R
        out = [1]
        for _ in range(len(items) - 1):
            out.append(out[-1] * r % R)
        return out

    def _pairing_batch(self, items) -> bool:
        """Combined check over [(C, z, y, proof)]:
        e(sum r^i (C_i - [y_i]G1 + [z_i]P_i), G2) * e(-sum r^i P_i,
        [tau]G2) == 1.

        The G1 generator terms fold into ONE point with the combined
        scalar -sum(y_i r^i) (scalar math is host-cheap), and with a
        segmented-MSM backend both point sums share one ladder walk."""
        rs = self._batch_r_powers(items)
        lhs_points, lhs_scalars = [], []
        proof_points, proof_scalars = [], []
        gen_scalar = 0
        for (cm, z, y, pr), r in zip(items, rs):
            lhs_points.append(cm)
            lhs_scalars.append(r)
            gen_scalar = (gen_scalar - y * r) % R
            lhs_points.append(pr)
            lhs_scalars.append(z * r % R)
            proof_points.append(pr)
            proof_scalars.append(r)
        lhs_points.append(G1_GEN)
        lhs_scalars.append(gen_scalar)
        if self._msm_multi is not None:
            pts = lhs_points + proof_points
            scs = lhs_scalars + proof_scalars
            gids = [0] * len(lhs_points) + [1] * len(proof_points)
            lhs, pagg = self._msm_multi(pts, scs, gids, 2)
        else:
            lhs = self._msm(lhs_points, lhs_scalars)
            pagg = self._msm(proof_points, proof_scalars)
        if pagg is None:
            return lhs is None
        pairs = []
        if lhs is not None:
            pairs.append((lhs, G2_GEN))
        pairs.append((C.g1_neg(pagg), self.setup.g2_tau))
        return self._pairing(pairs)
