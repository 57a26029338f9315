"""ECDSA P-256 keys and signatures: the port's copy of the JAX package's
``crypto/keys.py`` surface, served by the pure-Python backend
(``_fallback``) alone.

Reference parity:
- crypto/utils.go:26-33   SHA256
- crypto/utils.go:35-44   GenerateECDSAKey / Sign / Verify (raw r, s scalars)
- crypto/utils.go:46-58   To/FromECDSAPub (uncompressed SEC1 point)

Signatures are exchanged as raw (r, s) integer pairs, as in the
reference's wire format.  The JAX package signs with ``cryptography``
where it is installed (a random nonce) and with the same fallback where
it is not; both verify each other's signatures.  PEM key files
(``PemKeyFile``, ``pem_dump``) are RFC 5915 ``EC PRIVATE KEY`` and
SubjectPublicKeyInfo blocks; either package reads the other's.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Tuple

from . import _fallback as _fb

#: P-256 group order (scalar derivation for seeded identities)
P256_ORDER = _fb.N


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


@dataclass
class KeyPair:
    """An ECDSA P-256 private key plus its public encodings."""

    private: _fb.FallbackPrivateKey

    @property
    def public(self) -> _fb.FallbackPublicKey:
        return self.private.public_key()

    @property
    def pub_bytes(self) -> bytes:
        return pub_bytes(self.public)

    @property
    def pub_hex(self) -> str:
        return pub_hex(self.public)

    def sign_digest(self, digest: bytes) -> Tuple[int, int]:
        return sign(self.private, digest)


def generate_key() -> KeyPair:
    return KeyPair(_fb.generate_private_key())


def key_from_scalar(d: int) -> KeyPair:
    """Deterministic keypair from a private scalar: the same scalar gives
    the same key and the same signatures in every environment (seeded
    simulation identities)."""
    if not 1 <= d < _fb.N:
        raise ValueError("private scalar out of range for P-256")
    return KeyPair(_fb.FallbackPrivateKey(d))


def sign(private: _fb.FallbackPrivateKey, digest: bytes) -> Tuple[int, int]:
    """Sign a 32-byte SHA-256 digest; returns raw (r, s) scalars."""
    return _fb.sign(private, digest)


def verify(public: _fb.FallbackPublicKey, digest: bytes, r: int,
           s: int) -> bool:
    return _fb.verify(public, digest, r, s)


def pub_bytes(public: _fb.FallbackPublicKey) -> bytes:
    """Uncompressed SEC1 point (0x04 || X || Y), 65 bytes — the
    reference's elliptic.Marshal encoding (crypto/utils.go:46-49)."""
    return public.sec1()


def pub_hex(public: _fb.FallbackPublicKey) -> str:
    """'0x' + upper-hex of the SEC1 point — the participant identity
    string (reference event.go:107-112 Creator())."""
    return "0x" + pub_bytes(public).hex().upper()


#: SEC1 bytes -> decoded key (a fleet has a handful of keys; a hostile
#: stream of unknown keys clears the map instead of growing it)
_PUB_CACHE: dict = {}
_PUB_CACHE_MAX = 256


def from_pub_bytes(data: bytes) -> _fb.FallbackPublicKey:
    key = bytes(data)
    pub = _PUB_CACHE.get(key)
    if pub is None:
        pub = _fb.FallbackPublicKey.from_sec1(key)
        if len(_PUB_CACHE) >= _PUB_CACHE_MAX:
            _PUB_CACHE.clear()
        _PUB_CACHE[key] = pub
    return pub


def pub_hex_to_bytes(hex_id: str) -> bytes:
    if hex_id.startswith("0x") or hex_id.startswith("0X"):
        hex_id = hex_id[2:]
    return bytes.fromhex(hex_id)


class PemKeyFile:
    """priv_key.pem in a datadir (reference crypto/pem_key.go:29-31)."""

    FILENAME = "priv_key.pem"

    def __init__(self, datadir: str):
        self.path = os.path.join(datadir, self.FILENAME)

    def read(self) -> KeyPair:
        with open(self.path, "rb") as f:
            return KeyPair(_fb.private_key_from_pem(f.read()))

    def write(self, key: KeyPair) -> None:
        pem = _fb.private_key_pem(key.private)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "wb") as f:
            f.write(pem)

    def exists(self) -> bool:
        return os.path.exists(self.path)


def pem_dump(key: KeyPair) -> Tuple[str, str]:
    """(private_pem, public_pem) strings — the `keygen` CLI output
    (reference cmd/main.go keygen + crypto/pem_key.go GeneratePemKey)."""
    return (
        _fb.private_key_pem(key.private).decode(),
        _fb.public_key_pem(key.public).decode(),
    )
