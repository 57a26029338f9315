"""ECDSA P-256 keys and signatures (``keys``), on the pure-Python
backend (``_fallback``)."""

from .keys import (
    KeyPair, from_pub_bytes, generate_key, key_from_scalar, pub_bytes,
    pub_hex, pub_hex_to_bytes, sha256, sign, verify,
)

__all__ = [
    "KeyPair", "from_pub_bytes", "generate_key", "key_from_scalar",
    "pub_bytes", "pub_hex", "pub_hex_to_bytes", "sha256", "sign", "verify",
]
