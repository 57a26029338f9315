"""Pure-Python P-256 ECDSA: the port's copy of the JAX package's
``crypto/_fallback.py`` (the curve, the comb tables, the key objects,
deterministic-nonce signing and verification; the PEM helpers are not
copied yet).

The port signs and verifies with this backend only, because the card's
machine has no ``cryptography`` package.  NIST P-256 group arithmetic
on Python ints, ECDSA over SHA-256 digests with raw (r, s) scalars and
SEC1 point encoding.  Signatures are byte-equal to the JAX package's
fallback for the same key and digest (the nonce is an HMAC of the key
and the digest), and verify under either package's backend.

NOT constant-time and therefore not side-channel hardened: a co-located
attacker timing this code could recover keys.
"""

from __future__ import annotations

import hashlib
import hmac
import itertools
import secrets
from typing import Optional, Tuple

# NIST P-256 (secp256r1) domain parameters
P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
A = P - 3
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5

_Point = Optional[Tuple[int, int]]  # affine; None = point at infinity


def _on_curve(pt: _Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    if not (0 <= x < P and 0 <= y < P):
        return False
    return (y * y - (x * x * x + A * x + B)) % P == 0


# Jacobian coordinates: one field inversion per scalar multiplication
# instead of one per group addition (~10x for 256-bit scalars).

def _to_jac(pt: _Point):
    if pt is None:
        return (0, 1, 0)
    return (pt[0], pt[1], 1)


def _from_jac(pt) -> _Point:
    x, y, z = pt
    if z == 0:
        return None
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def _jac_double(pt):
    x, y, z = pt
    if z == 0 or y == 0:
        return (0, 1, 0)
    ysq = y * y % P
    s = 4 * x * ysq % P
    m = (3 * x * x + A * z * z * z * z) % P
    nx = (m * m - 2 * s) % P
    ny = (m * (s - nx) - 8 * ysq * ysq) % P
    nz = 2 * y * z % P
    return (nx, ny, nz)


def _jac_add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1sq = z1 * z1 % P
    z2sq = z2 * z2 % P
    u1 = x1 * z2sq % P
    u2 = x2 * z1sq % P
    s1 = y1 * z2sq * z2 % P
    s2 = y2 * z1sq * z1 % P
    if u1 == u2:
        if s1 != s2:
            return (0, 1, 0)
        return _jac_double(p)
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    hsq = h * h % P
    hcu = hsq * h % P
    nx = (r * r - hcu - 2 * u1 * hsq) % P
    ny = (r * (u1 * hsq - nx) - s1 * hcu) % P
    nz = h * z1 * z2 % P
    return (nx, ny, nz)


def _mul(k: int, pt: _Point) -> _Point:
    acc = (0, 1, 0)
    add = _to_jac(pt)
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        add = _jac_double(add)
        k >>= 1
    return _from_jac(acc)


# ----------------------------------------------------------------------
# fixed-base comb tables
#
# The live fleet signs one event per gossip exchange and verifies every
# peer event it inserts; at fleet rates the double-and-add ladder above
# (~256 doublings + ~128 additions per scalar mult) IS the hot path.
# Both ECDSA mults have a fixed or nearly-fixed base — k*G always, and
# u2*Q over the handful of fleet public keys — so a 4-bit fixed-window
# comb (64 rows of the 15 odd multiples of 16^i * T) turns each mult
# into <=64 additions, ~20x fewer group ops.  Tables build lazily (one
# ~15 ms pass per point) and are cached: one for G, a bounded map for
# recently-verified public keys.  Pure precomputation — the (r, s)
# values are bit-identical to the ladder's, so deterministic-nonce
# signatures (and therefore chaos fingerprints) are unchanged.  Like
# the rest of this module it is NOT constant-time.

class _CombTable:
    __slots__ = ("rows",)

    def __init__(self, pt: _Point):
        base = _to_jac(pt)
        rows = []
        for _ in range(64):
            row = [(0, 1, 0)]
            acc = (0, 1, 0)
            for _j in range(15):
                acc = _jac_add(acc, base)
                row.append(acc)
            rows.append(row)
            for _ in range(4):
                base = _jac_double(base)
        self.rows = rows

    def mul_jac(self, k: int):
        acc = (0, 1, 0)
        i = 0
        rows = self.rows
        while k:
            nib = k & 15
            if nib:
                acc = _jac_add(acc, rows[i][nib])
            k >>= 4
            i += 1
        return acc


_G_COMB: Optional[_CombTable] = None
#: affine point -> comb table; bounded (fleet key sets are small — the
#: clear-on-overflow keeps a hostile stream of unknown keys from
#: growing memory, at worst re-paying the build cost)
_POINT_COMBS: dict = {}
_POINT_COMBS_MAX = 64


def _g_comb() -> _CombTable:
    global _G_COMB
    if _G_COMB is None:
        _G_COMB = _CombTable((GX, GY))
    return _G_COMB


def _comb_for(pt: Tuple[int, int]) -> _CombTable:
    tbl = _POINT_COMBS.get(pt)
    if tbl is None:
        if len(_POINT_COMBS) >= _POINT_COMBS_MAX:
            _POINT_COMBS.clear()
        tbl = _CombTable(pt)
        _POINT_COMBS[pt] = tbl
    return tbl


# ----------------------------------------------------------------------
# key objects (the operations keys.py routes here)

class FallbackPublicKey:
    """An affine P-256 point acting as a verification key."""

    __slots__ = ("point",)

    def __init__(self, point: Tuple[int, int]):
        if point is None or not _on_curve(point):
            raise ValueError("point is not on the P-256 curve")
        self.point = point

    def sec1(self) -> bytes:
        x, y = self.point
        return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")

    @classmethod
    def from_sec1(cls, data: bytes) -> "FallbackPublicKey":
        if len(data) != 65 or data[0] != 0x04:
            raise ValueError("expected a 65-byte uncompressed SEC1 point")
        return cls((int.from_bytes(data[1:33], "big"),
                    int.from_bytes(data[33:], "big")))


class FallbackPrivateKey:
    """A P-256 scalar acting as a signing key."""

    __slots__ = ("d", "_public")

    def __init__(self, d: int):
        if not (1 <= d < N):
            raise ValueError("private scalar out of range")
        self.d = d
        self._public: Optional[FallbackPublicKey] = None

    def public_key(self) -> FallbackPublicKey:
        if self._public is None:
            self._public = FallbackPublicKey(_mul(self.d, (GX, GY)))
        return self._public


def generate_private_key() -> FallbackPrivateKey:
    return FallbackPrivateKey(secrets.randbelow(N - 1) + 1)


# ----------------------------------------------------------------------
# ECDSA over a 32-byte SHA-256 digest, raw (r, s) scalars

def _det_nonce(d: int, digest: bytes, counter: int) -> int:
    """Deterministic ECDSA nonce in [1, N-1]: HMAC-SHA256 keyed by the
    private scalar over the digest (RFC-6979 in spirit — same security
    argument: k is a secret PRF of (key, message), so it never repeats
    across distinct digests and never leaks).  Deterministic signing
    removes the RNG-failure bug class entirely AND makes signatures —
    and therefore event identity hashes, which cover (r, s) — a pure
    function of (key, body): the chaos plane's bit-for-bit scenario
    reproducibility rests on this."""
    mac = hmac.new(
        d.to_bytes(32, "big"),
        digest + counter.to_bytes(4, "big"),
        hashlib.sha256,
    ).digest()
    return int.from_bytes(mac, "big") % (N - 1) + 1


def sign(private: FallbackPrivateKey, digest: bytes) -> Tuple[int, int]:
    if len(digest) != 32:
        # match the hazmat backend (Prehashed(SHA256()) raises on any
        # other length) so a caller bug surfaces on both backends
        raise ValueError(f"expected a 32-byte SHA-256 digest, got "
                         f"{len(digest)} bytes")
    z = int.from_bytes(digest, "big")
    for counter in itertools.count():
        k = _det_nonce(private.d, digest, counter)
        pt = _from_jac(_g_comb().mul_jac(k))
        r = pt[0] % N
        if r == 0:
            continue
        s = pow(k, -1, N) * (z + r * private.d) % N
        if s == 0:
            continue
        return r, s


def verify(public: FallbackPublicKey, digest: bytes, r: int, s: int) -> bool:
    # wrong-length digest verifies False, same as keys.verify's hazmat
    # path (Prehashed raises ValueError there, caught -> False)
    if len(digest) != 32 or not (1 <= r < N and 1 <= s < N):
        return False
    z = int.from_bytes(digest, "big")
    w = pow(s, -1, N)
    # comb-table evaluation for both mults: u1*G off the shared G table,
    # u2*Q off the per-key cache (fleet key sets are tiny, so after the
    # first verify per key this is ~64+64 additions total)
    pt = _jac_add(
        _g_comb().mul_jac(z * w % N),
        _comb_for(public.point).mul_jac(r * w % N),
    )
    aff = _from_jac(pt)
    if aff is None:
        return False
    return aff[0] % N == r


