"""ECDSA P-256 keys, signatures and PEM key files (``keys``), on the
pure-Python backend (``_fallback``)."""

from .keys import (
    KeyPair, PemKeyFile, from_pub_bytes, generate_key, key_from_scalar,
    pem_dump, pub_bytes, pub_hex, pub_hex_to_bytes, sha256, sign, verify,
)

__all__ = [
    "KeyPair", "PemKeyFile", "from_pub_bytes", "generate_key",
    "key_from_scalar", "pem_dump", "pub_bytes", "pub_hex",
    "pub_hex_to_bytes", "sha256", "sign", "verify",
]
