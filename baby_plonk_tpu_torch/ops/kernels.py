"""The port's CUDA library, and the sub-NTT wrappers.

Build: ``field_asm.header()`` (the inline-PTX carry chains of the field
arithmetic) is written into the build directory, every ``csrc/*.cu`` is
compiled by ``nvcc`` for ``sm_90a`` into one object each (all started
together), then all are linked into one shared library
with a plain C interface, loaded through ``ctypes``. The build happens at
first use into ``baby_plonk_tpu_torch/build/`` (listed in ``.gitignore``),
keyed by a hash of the sources, so a checkout builds itself. Nothing here
builds or loads anything at import time.

Every C entry point launches on the caller's stream, allocates nothing and
returns ``cudaGetLastError()``; ``launch`` raises when that is not 0.

The sub-NTT wrappers (``ntt_sub``, ``ntt_sub_4step``) live here beside
their plain PyTorch versions; the NTT plans and ``ntt_device`` are in
``ops/ntt.py``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from . import field_asm

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("field.cu", "ntt.cu", "g1.cu", "msm.cu", "msm_fixed.cu", "srs.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, stack frame and spills of every kernel, kept by build()
)

_P = ctypes.c_void_p
_I = ctypes.c_longlong
#: C signature of every entry point (all return int = cudaError_t)
_SIGNATURES = {
    "bpt_field_op": [ctypes.c_int, ctypes.c_int, _P, _I, _I, _P, _I, _I, _P, _I, _P],
    "bpt_field_select": [ctypes.c_int, _P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _I, _P],
    "bpt_ntt_sub": [_P, _P, _P, _I, _I, _I, _I, _P],
    "bpt_g1_padd": [_P] * 9 + [_I, _P],
    "bpt_g1_pdouble": [_P] * 6 + [_I, _P],
    "bpt_msm_bitserial": [_P] * 4 + [_I, ctypes.c_int] + [_P] * 4,
    "bpt_msm_build_tables": [_P, _P, _P, _I, _P, _P, _P, _P],
    "bpt_msm_normalize_tables": [_P, _P, _P, _I, _P, _P],
    "bpt_msm_fixed": [_P, _P, _I, _I, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P],
    "bpt_msm_join": [_P, _P, _P, _I, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P],
    "bpt_powers_of_tau": [_P, _P, _I, _P, _P, _P, _P],
}

_lib = None


def _source_digest() -> str:
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + field_asm.header()).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile the sources (if their hash has no library yet); returns the
    library path. One ``nvcc`` per source, run in parallel, then a link."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libbpt_torch_{_source_digest()}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib_path):
            return lib_path
        objs = [os.path.join(BUILD_DIR, s.replace(".cu", ".o")) for s in SOURCES]
        # the carry chains that csrc/field.cuh includes
        with open(os.path.join(BUILD_DIR, "field_asm.cuh"), "w") as f:
            f.write(field_asm.header())

        def compile_one(src_obj):
            src, obj = src_obj
            cmd = [nvcc, *NVCC_FLAGS, "-I", BUILD_DIR, "-c", os.path.join(CSRC, src), "-o", obj]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
            with open(obj + ".ptxas.txt", "w") as f:
                f.write(res.stderr)

        with ThreadPoolExecutor(len(SOURCES)) as pool:
            list(pool.map(compile_one, zip(SOURCES, objs)))
        tmp = lib_path + ".tmp"
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", *objs, "-o", tmp, "-lcudart"],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stderr}")
        os.replace(tmp, lib_path)
    return lib_path


def resource_usage(source: str) -> str:
    """What ``ptxas -v`` said when ``source`` (a name in SOURCES) was last
    compiled: registers, stack frame and spill bytes per kernel."""
    build()
    with open(os.path.join(BUILD_DIR, source.replace(".cu", ".o") + ".ptxas.txt")) as f:
        return f.read()


def library():
    """The loaded CUDA library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry point ``name``; raise if the launch reported an error."""
    rc = getattr(library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(*tensors: torch.Tensor, dtype=torch.int32) -> torch.device:
    """All tensors on one CUDA device with ``dtype``; returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"kernel operand dtype {t.dtype}, expected {dtype}")
    return dev


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain path); a mix of
    devices is an error."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if "cpu" in kinds:
        raise ValueError("operands mix CPU and CUDA tensors")
    return False


# -----------------------------------------------------------------------------
# Sub-NTT (counterpart of ops/pallas_kernels.py::ntt_sub_pallas, :355)
# -----------------------------------------------------------------------------

#: Largest sub-NTT length the single-pass kernel takes: one block holds
#: m * C Montgomery elements of 32 bytes in shared memory with m * C = 1024
#: (32 KB, inside the 48 KB a block gets without opting in). Longer
#: transforms split into m1 x m2 through ``ntt_sub_4step``.
SUB_MAX_M = 1024


def _columns_per_block(m: int, B: int) -> int:
    c = 1
    while c * 2 * m <= SUB_MAX_M and B % (c * 2) == 0:
        c *= 2
    return c


def ntt_sub_plain(a: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """Plain version of ``ntt_sub``: the same radix-2 decimation-in-
    frequency stages over axis -2 on int64 limbs. pw (16, m/2) holds the
    Montgomery powers w^k of the sub-root."""
    from . import limbs

    spec = limbs.FR
    L, K, m, B = a.shape
    x = a
    length = m // 2
    while length >= 1:
        blocks = m // (2 * length)
        x = x.reshape(L, K, blocks, 2, length, B)
        u, v = x[:, :, :, 0], x[:, :, :, 1]
        e = torch.arange(length, device=a.device) * blocks  # w^(off * m/(2 len))
        w = pw[:, e].reshape(L, 1, 1, length, 1)
        s = limbs._add_plain(spec, u, v)
        d = limbs._mont_mul_plain(spec, limbs._sub_plain(spec, u, v), w)
        x = torch.stack([s, d], dim=3).reshape(L, K, m, B)
        length //= 2
    return x


def ntt_sub(a: torch.Tensor, inverse: bool) -> torch.Tensor:
    """All log2(m) butterfly stages of a length-m Fr NTT along axis -2 of a
    (16, K, m, B) Montgomery batch (K and B are batch axes), output rows in
    BIT-REVERSED order, no 1/m scaling — the contract of
    ``ntt_sub_pallas`` (ops/pallas_kernels.py:355), with the batch axes the
    TPU kernel lacked. m <= SUB_MAX_M."""
    from . import ntt

    L, K, m, B = a.shape
    if L != 16 or m & (m - 1) or m > SUB_MAX_M:
        raise ValueError(f"ntt_sub: bad shape {tuple(a.shape)}")
    if m == 1:
        return a
    pw = ntt.sub_twiddles(m, inverse, a.device)
    if on_cpu(a):
        return ntt_sub_plain(a, pw).to(torch.int32)
    dev = check_cuda(a, pw)
    a = a.contiguous()
    out = torch.empty_like(a)
    cols = _columns_per_block(m, B)
    launch("bpt_ntt_sub", ptr(a), ptr(out), ptr(pw), K, m, B, cols, stream(dev))
    ntt_sub.launches += 1
    return out


ntt_sub.launches = 0


def ntt_sub_4step(a: torch.Tensor, inverse: bool, sub_max: int | None = None,
                  plain: bool = False) -> torch.Tensor:
    """Natural-order length-m Fr NTT along axis -2 of (16, K, m, B) as
    m = m1 x m2 (counterpart of ``ntt_sub_pallas_4step``,
    ops/pallas_kernels.py:402): sub-NTT over m1 (lanes m2*B), bit-reversal
    row gather, cross-twiddle multiply by w^(j1*i2), transpose, sub-NTT over
    m2 (lanes m1*B), bit-reversal gather. A factor above ``sub_max``
    (default SUB_MAX_M) recurses. No 1/m scaling.

    A composition: its sub-passes launch ``ntt_sub`` and the cross-twiddle
    multiply launches ``limbs.mont_mul``; ``launches`` counts the
    compositions run on the card. ``plain`` runs the plain versions of both
    whatever the device (the reference on the card)."""
    from . import limbs, ntt

    sub_max = SUB_MAX_M if sub_max is None else sub_max
    L, K, m, B = a.shape
    if m == 1:
        return a
    m1, m2, crossT, br1, br2 = ntt.plan4(m, inverse, a.device)

    def sub(x, mm, br):  # natural-order length-mm NTT along axis -2
        if mm > sub_max:
            return ntt_sub_4step(x, inverse, sub_max, plain)
        if plain:
            x = ntt_sub_plain(x, ntt.sub_twiddles(mm, inverse, x.device))
        else:
            x = ntt_sub(x, inverse)
        return x.index_select(2, br)

    x = sub(a.reshape(L, K, m1, m2 * B), m1, br1).reshape(L, K, m1, m2, B)
    w = crossT.reshape(L, 1, m1, m2, 1)
    if plain:
        x = limbs._mont_mul_plain(limbs.FR, x, w).to(torch.int32)
    else:
        x = limbs.mont_mul(limbs.FR, x, w)
    x = sub(x.transpose(2, 3).reshape(L, K, m2, m1 * B), m2, br2)
    if not plain and not on_cpu(a):
        ntt_sub_4step.launches += 1
    # rows are (j2, j1): flattening gives index j1 + m1*j2, natural order
    return x.reshape(L, K, m, B)


ntt_sub_4step.launches = 0
