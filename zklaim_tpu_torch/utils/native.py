"""ctypes bindings for the native host library (native/libzklaim_host.so).

Provides SHA256, ECDSA-Ed25519 and the context wire codec as native
code, mirroring the reference's native host layer (libgcrypt + OpenSSL;
reference zklaim/zklaim_hash.c, zklaim/zklaim_ecc.c).  Every entry point
degrades gracefully: if the library is absent (not built), callers fall
back to the pure-Python implementations -- behavior is identical, only
speed differs.  Build with `make -C native`.

Copy of zklaim_tpu/utils/native.py kept inside this package, which imports nothing
of the JAX package: the code is identical, and the relative imports
resolve to this package's own copies.
"""

from __future__ import annotations

import ctypes
import os

_LIB = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SO_PATH = os.path.join(_ROOT, "native", "libzklaim_host.so")


def get_lib():
    """The loaded library or None (missing/unbuildable)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.zkn_sha256.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p]
    lib.zkn_ecdsa_sign.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_char_p, ctypes.c_char_p, u8p]
    lib.zkn_ecdsa_sign.restype = ctypes.c_int
    lib.zkn_ecdsa_verify.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_char_p, ctypes.c_char_p]
    lib.zkn_ecdsa_verify.restype = ctypes.c_int
    lib.zkn_ecdsa_pub.argtypes = [ctypes.c_char_p, u8p]
    lib.zkn_ecdsa_pub.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def available() -> bool:
    return get_lib() is not None


def sha256(data: bytes) -> bytes:
    lib = get_lib()
    out = (ctypes.c_uint8 * 32)()
    lib.zkn_sha256(data, len(data), out)
    return bytes(out)


def ecdsa_sign(msg: bytes, priv64: bytes, k32: bytes) -> bytes | None:
    lib = get_lib()
    sig = (ctypes.c_uint8 * 64)()
    if lib.zkn_ecdsa_sign(msg, len(msg), priv64, k32, sig):
        return None
    return bytes(sig)


def ecdsa_verify(msg: bytes, sig64: bytes, pub32: bytes) -> bool:
    lib = get_lib()
    return lib.zkn_ecdsa_verify(msg, len(msg), sig64, pub32) == 0


def ecdsa_pub(priv64: bytes) -> bytes:
    lib = get_lib()
    out = (ctypes.c_uint8 * 32)()
    lib.zkn_ecdsa_pub(priv64, out)
    return bytes(out)
