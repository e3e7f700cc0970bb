"""Dependency-free authenticated encryption for model artifacts (a copy of
``analytics_zoo_tpu/utils/crypto.py``: the same wire format, so either
package opens what the other sealed).

The reference serves encrypted OpenVINO/BigDL models
(InferenceModel.scala:315-323 doLoadEncryptedOpenVINO — decrypt with a
secret key before loading, so model weights at rest on serving hosts are
not plaintext). The TPU-native analogue is format-agnostic: encrypt the
serialized checkpoint bytes themselves.

Scheme (stdlib only — the TPU image carries no cryptography package):

* key derivation: PBKDF2-HMAC-SHA256 over the passphrase with a random
  16-byte salt (200k iterations) → one 32-byte master key, split into an
  encryption key and a MAC key via HMAC domain separation;
* cipher: HMAC-SHA256 in counter mode as the keystream PRF (a standard
  PRF→stream-cipher construction). The keystream is generated with one
  single-iteration PBKDF2 call — PBKDF2's block function at iterations=1
  IS HMAC(key, nonce ‖ counter_be32), and hashlib.pbkdf2_hmac runs the
  whole block chain in OpenSSL C (~60 MB/s measured end-to-end vs
  ~15 MB/s for a per-block Python loop);
* integrity: encrypt-then-MAC with HMAC-SHA256 over header ‖ ciphertext —
  tampering or a wrong key fails loudly BEFORE any unpickling happens,
  which also keeps `load_encrypted` safe against pickle-bomb swaps.

Wire format v2: MAGIC2 ‖ salt(16) ‖ nonce(16) ‖ ciphertext ‖ tag(32),
keystream generated in 64 MB segments with the segment index appended to
the nonce — whole-buffer big-int XOR materialized ~3-4 full-size copies,
so a multi-GB checkpoint peaked at several times its size in host memory
(round-4 advisor); segments bound the transient copies at 64 MB each.
v1 artifacts (single whole-buffer keystream) remain readable.
"""

from __future__ import annotations

import hashlib
import hmac
import os

MAGIC = b"ZOOENC1\x00"
MAGIC2 = b"ZOOENC2\x00"
_ITERATIONS = 200_000
_SEGMENT = 64 << 20


def _derive_keys(passphrase: str, salt: bytes):
    master = hashlib.pbkdf2_hmac("sha256", passphrase.encode("utf-8"),
                                 salt, _ITERATIONS, dklen=32)
    enc_key = hmac.new(master, b"encrypt", hashlib.sha256).digest()
    mac_key = hmac.new(master, b"mac", hashlib.sha256).digest()
    return enc_key, mac_key


def _keystream_xor(enc_key: bytes, nonce: bytes, data: bytes) -> bytes:
    """v1 path: one whole-buffer keystream (kept for reading old
    artifacts; peaks at several times the data size in host memory)."""
    if not data:
        return b""
    # PBKDF2(iterations=1, dklen=n) == HMAC(key, nonce || be32(i)) block
    # chain, computed entirely inside OpenSSL — the fast stdlib route to
    # an HMAC-CTR keystream
    stream = hashlib.pbkdf2_hmac("sha256", enc_key, nonce, 1,
                                 dklen=len(data))
    # whole-buffer XOR through big ints: C-speed, no per-byte Python loop
    return (int.from_bytes(data, "big") ^
            int.from_bytes(stream, "big")).to_bytes(len(data), "big")


def _keystream_xor_segmented(enc_key: bytes, nonce: bytes,
                             data: bytes) -> bytes:
    """v2 path: independent 64 MB keystream segments (segment index
    appended to the nonce), so transient copies are bounded at segment
    size instead of the whole artifact."""
    out = []
    for seg, j in enumerate(range(0, len(data), _SEGMENT)):
        chunk = data[j:j + _SEGMENT]
        seg_nonce = nonce + seg.to_bytes(4, "big")
        stream = hashlib.pbkdf2_hmac("sha256", enc_key, seg_nonce, 1,
                                     dklen=len(chunk))
        out.append((int.from_bytes(chunk, "big") ^
                    int.from_bytes(stream, "big"))
                   .to_bytes(len(chunk), "big"))
    return b"".join(out)


def encrypt_bytes(data: bytes, passphrase: str) -> bytes:
    salt, nonce = os.urandom(16), os.urandom(16)
    enc_key, mac_key = _derive_keys(passphrase, salt)
    ct = _keystream_xor_segmented(enc_key, nonce, data)
    header = MAGIC2 + salt + nonce
    tag = hmac.new(mac_key, header + ct, hashlib.sha256).digest()
    return header + ct + tag


def decrypt_bytes(blob: bytes, passphrase: str) -> bytes:
    if len(blob) < len(MAGIC) + 16 + 16 + 32 or \
            not (blob.startswith(MAGIC) or blob.startswith(MAGIC2)):
        raise ValueError("not an analytics-zoo-tpu encrypted artifact")
    v2 = blob.startswith(MAGIC2)
    off = len(MAGIC2) if v2 else len(MAGIC)
    salt, nonce = blob[off:off + 16], blob[off + 16:off + 32]
    ct, tag = blob[off + 32:-32], blob[-32:]
    enc_key, mac_key = _derive_keys(passphrase, salt)
    expect = hmac.new(mac_key, blob[:-32 - len(ct)] + ct,
                      hashlib.sha256).digest()
    if not hmac.compare_digest(tag, expect):
        raise ValueError("decryption failed: wrong key or tampered "
                         "artifact (integrity check)")
    xor = _keystream_xor_segmented if v2 else _keystream_xor
    return xor(enc_key, nonce, ct)
