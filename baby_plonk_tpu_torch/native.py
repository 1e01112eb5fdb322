"""ctypes bindings of the port's native host helpers, each its own library:

- Keccak-f[1600] (csrc/host/bpt_native.c; counterpart of
  ``baby_plonk_tpu/native.py``), plain C bound with ``ctypes.CDLL``;
- the witness reader of round 1 (csrc/host/witness.c), built against
  Python's headers and bound with ``ctypes.PyDLL``, which holds the GIL
  through the call.

Each is compiled on first use with the system C compiler into the package's
gitignored ``build/`` directory; callers fall back to the pure-Python
paths if the toolchain, the headers or the library are unavailable, so the
package works without native code (it is then slower).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import sysconfig
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "host", "bpt_native.c")
_BUILD_DIR = os.path.join(_HERE, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libbpt_native.so")
_WITNESS_SRC = os.path.join(_HERE, "csrc", "host", "witness.c")
# built against this interpreter's headers: named after its version
_WITNESS_LIB = os.path.join(_BUILD_DIR, f"libbpt_witness.{sys.implementation.cache_tag}.so")

_lock = threading.Lock()
_libs: dict = {}


def _build(src: str, lib_path: str, flags=()) -> None:
    """Compile ``src`` into ``lib_path`` unless a build newer than it is there."""
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= os.path.getmtime(src):
        return
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # several processes may build at once: each writes its own file and
    # renames it into place
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    subprocess.run(["cc", "-O3", "-shared", "-fPIC", *flags, "-o", tmp, src], check=True, capture_output=True)
    os.replace(tmp, lib_path)


def _once(name: str, open_lib):
    """``open_lib()``, tried once a process; None if it raised."""
    with _lock:
        if name not in _libs:
            try:
                _libs[name] = open_lib()
            except Exception:
                _libs[name] = None
        return _libs[name]


def _open_keccak():
    _build(_SRC, _LIB_PATH)
    lib = ctypes.CDLL(_LIB_PATH)
    lib.keccak_f1600.argtypes = [ctypes.c_void_p]
    return lib


def _open_witness():
    _build(_WITNESS_SRC, _WITNESS_LIB, ["-I", sysconfig.get_paths()["include"]])
    fn = ctypes.PyDLL(_WITNESS_LIB).bpt_read_witness
    fn.argtypes = [ctypes.py_object, ctypes.py_object] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_ssize_t
    return fn


def _load():
    return _once("keccak", _open_keccak)


def available() -> bool:
    return _load() is not None


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state (native)."""
    lib = _load()
    assert lib is not None
    buf = (ctypes.c_uint8 * 200).from_buffer(state)
    lib.keccak_f1600(buf)


def witness_reader():
    """``bpt_read_witness(witness, keys, slots, q, out, flagged)``
    (csrc/host/witness.c; the arrays as addresses), or None where the
    library cannot be built or loaded."""
    return _once("witness", _open_witness)
