"""Model encryption: AES-CTR cipher over the native runtime (counterpart
of paddle_tpu/utils/crypto.py, copied onto the port's core/native.py; the
blob layout is the JAX package's, so either package decrypts the other's).

Reference parity: paddle/fluid/framework/io/crypto/ — ``Cipher`` /
``CipherFactory`` (cipher.h) and ``AESCipher`` (aes_cipher.cc, cryptopp),
used to encrypt inference-model files.  A self-contained
FIPS-197 AES core in native/src/crypto.cc (C++, validated against the
FIPS-197 and SP 800-38A known-answer vectors) in
CTR mode, driven over ctypes; files carry a 16-byte random IV header.
"""
from __future__ import annotations

import ctypes
import hashlib
import hmac as _hmac
import os
from typing import Optional

from ..core import native as _native

_MAGIC = b"PDTPU\x01"   # legacy v1 header: magic + 16-byte IV (no auth tag)
_MAGIC2 = b"PDTPU\x02"  # v2 header: magic + IV + ct + HMAC-SHA256(iv||ct)
_TAG_LEN = 32


class Cipher:
    """AES-CTR cipher (ref cipher.h Cipher).  ``key`` is 16/24/32 raw
    bytes.

    Blobs are authenticated: encrypt() appends an HMAC-SHA256 tag (keyed by
    a digest-separated derivation of ``key``) over ``iv || ciphertext``, and
    decrypt() rejects tampered or truncated blobs with ``ValueError``.
    There is no unauthenticated fallback — pre-tag v1 blobs (``PDTPU\\x01``,
    never shipped) are rejected, so the tag cannot be stripped by rewriting
    the magic (downgrade attack).  The reference's AESCipher
    (aes_cipher.cc) is unauthenticated; this is a deliberate strengthening.
    """

    def __init__(self, key: bytes):
        if len(key) not in (16, 24, 32):
            raise ValueError(
                f"AES key must be 16/24/32 bytes, got {len(key)}")
        self._key = bytes(key)
        lib = _native.get_lib()
        if lib is None:
            raise RuntimeError(
                "native runtime unavailable; build native/ first "
                "(make -C native)")
        self._lib = lib

    def _crypt(self, data: bytes, iv: bytes) -> bytes:
        buf = bytearray(data)
        if buf:
            c_buf = (ctypes.c_uint8 * len(buf)).from_buffer(buf)
            rc = self._lib.pd_aes_ctr_crypt(self._key, len(self._key), iv,
                                            c_buf, len(buf))
            if rc != 0:
                raise RuntimeError("pd_aes_ctr_crypt failed")
        return bytes(buf)

    def _mac_key(self) -> bytes:
        return hashlib.sha256(b"pdtpu-mac:" + self._key).digest()

    def encrypt(self, plaintext: bytes, iv: Optional[bytes] = None) -> bytes:
        """Returns header || iv || ciphertext || tag (ref AESCipher::Encrypt,
        plus integrity the reference lacks)."""
        iv = os.urandom(16) if iv is None else bytes(iv)
        if len(iv) != 16:
            raise ValueError("IV must be 16 bytes")
        ct = self._crypt(plaintext, iv)
        tag = _hmac.new(self._mac_key(), iv + ct, hashlib.sha256).digest()
        return _MAGIC2 + iv + ct + tag

    def decrypt(self, blob: bytes) -> bytes:
        if blob[:len(_MAGIC2)] == _MAGIC2:
            body = blob[len(_MAGIC2):]
            if len(body) < 16 + _TAG_LEN:
                raise ValueError("encrypted blob truncated")
            iv, ct, tag = body[:16], body[16:-_TAG_LEN], body[-_TAG_LEN:]
            want = _hmac.new(self._mac_key(), iv + ct,
                             hashlib.sha256).digest()
            if not _hmac.compare_digest(tag, want):
                raise ValueError(
                    "encrypted blob failed authentication (wrong key or "
                    "tampered data)")
            return self._crypt(ct, iv)
        if blob[:len(_MAGIC)] == _MAGIC:
            raise ValueError(
                "unauthenticated v1 blob rejected (re-encrypt with the "
                "current format; v1 acceptance would enable a tag-stripping "
                "downgrade)")
        raise ValueError("not a paddle_tpu encrypted blob (bad magic)")

    def encrypt_to_file(self, plaintext: bytes, path: str) -> None:
        """ref AESCipher::EncryptToFile."""
        with open(path, "wb") as f:
            f.write(self.encrypt(plaintext))

    def decrypt_from_file(self, path: str) -> bytes:
        """ref AESCipher::DecryptFromFile."""
        with open(path, "rb") as f:
            return self.decrypt(f.read())


class CipherFactory:
    """ref cipher.h CipherFactory::CreateCipher — the reference reads a
    cipher-config file naming the algorithm; only AES-CTR exists here."""

    @staticmethod
    def create_cipher(key: bytes) -> Cipher:
        return Cipher(key)


def generate_key(n_bytes: int = 32) -> bytes:
    """Random AES key (ref CipherUtils::GenKey)."""
    if n_bytes not in (16, 24, 32):
        raise ValueError("AES key length must be 16/24/32 bytes")
    return os.urandom(n_bytes)
