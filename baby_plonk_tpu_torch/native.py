"""ctypes binding of the port's native host helper, Keccak-f[1600]
(csrc/host/bpt_native.c; counterpart of ``baby_plonk_tpu/native.py``).

Compiled on first use with the system C compiler into the package's
gitignored ``build/`` directory; callers fall back to the pure-Python
paths if the toolchain or the library is unavailable, so the package works
without native code (transcript hashing is then slower).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "host", "bpt_native.c")
_BUILD_DIR = os.path.join(_HERE, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libbpt_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_LIB_PATH) or os.path.getmtime(
                _LIB_PATH
            ) < os.path.getmtime(_SRC):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                # several processes may build at once: each writes its own
                # file and renames it into place
                tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
                subprocess.run(
                    ["cc", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _LIB_PATH)
            lib = ctypes.CDLL(_LIB_PATH)
            lib.keccak_f1600.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state (native)."""
    lib = _load()
    assert lib is not None
    buf = (ctypes.c_uint8 * 200).from_buffer(state)
    lib.keccak_f1600(buf)
