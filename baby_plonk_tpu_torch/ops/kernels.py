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
``ops/ntt.py``. On the card a four-step transform is two launches of one
kernel (csrc/ntt.cu): the bit reversal, the cross-twiddle multiply, the
1/n of a scaled inverse and the transpose are index maps and one multiply
in its epilogue.
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
SOURCES = ("field.cu", "ntt.cu", "g1.cu", "msm.cu", "msm_fixed.cu", "srs.cu", "pippenger.cu")
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
    "bpt_field_pow": [ctypes.c_int, _P, _P, _I, _P, ctypes.c_int, _P],
    "bpt_field_scan": [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _I, _I, ctypes.c_int, ctypes.c_int, _P],
    "bpt_field_pow_table": [ctypes.c_int, _P, _P, _I, _P],
    "bpt_grand_product_fg": [_P] * 10 + [_I, _P],
    "bpt_round3_combine": [_P] * 7 + [_I, _I, _P],
    "bpt_ntt_sub": [_P, _P, _P, _P] + [_I] * 11 + [ctypes.c_int, _P],
    "bpt_g1_padd": [_P] * 9 + [_I, _P],
    "bpt_g1_pdouble": [_P] * 6 + [_I, _P],
    "bpt_g1_tree": [_P] * 3 + [_I] * 9 + [_P] * 5,
    "bpt_msm_bitserial": [_P] * 4 + [_I, ctypes.c_int] + [_P] * 4,
    "bpt_msm_build_tables": [_P, _P, _P, _I] + [_P] * 5,
    "bpt_msm_fixed": [_P, _P, _I, _I, ctypes.c_int, ctypes.c_int, ctypes.c_int, _I, _I, _I, _P, _P, _P, _P],
    "bpt_msm_join": [_P, _P, _P, _I, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P],
    "bpt_powers_of_tau": [_P, _P, _I, _P, _P, _P, _P],
    "bpt_msm_pippenger": [_P] * 3 + [_I, _P, _P, ctypes.c_int] + [_I] * 4 + [_P, _I] + [_P] * 4,
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
        lib.bpt_ntt_sub_smem.argtypes = [_I, _I]
        lib.bpt_ntt_sub_smem.restype = _I
        lib.bpt_msm_pippenger_scratch.argtypes = [_I, ctypes.c_int] + [_I] * 4
        lib.bpt_msm_pippenger_scratch.restype = _I
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` with ``args`` and the current stream of
    ``device`` (the last parameter of every entry point), with ``device``
    the thread's current device: a kernel launches on the current device,
    so a tensor of another card needs the switch. The switch is made only
    where the devices differ. Raise if the launch reported an error."""
    fn = getattr(library(), name)
    s = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        rc = fn(*args, s)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, s)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


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

#: Largest sub-NTT length the single-pass kernel takes: at m = 1024 a block
#: holds 4 columns (161 KB of the 227 KB of shared memory a block may opt
#: in to). Longer transforms split into m1 x m2 through ``ntt_sub_4step``.
SUB_MAX_M = 1024
#: Shared memory a block may use on this card (bytes)
SMEM_BLOCK = 232448
#: Columns a block takes where there are that many: 8 int32 limbs are one
#: full 32-byte sector of a limb plane
COLUMNS = 8


def sub_smem_bytes(m: int, c: int) -> int:
    """Shared memory of one ``ntt_sub_kernel`` block (csrc/ntt.cu::
    bpt_ntt_sub_smem): 8 word planes of c padded columns, m - 1 twiddles."""
    return 32 * (c * (m + (32 // c if c < 32 else 1)) + m - 1)


def _columns_per_block(m: int, ncols: int) -> int:
    """Columns a block takes: the largest power of two up to COLUMNS that
    divides ``ncols``, halved while one block's shared memory does not fit
    (m = 1024 runs at 4). Measured at m = 512: 8 columns at one block an SM
    beat 4 columns at two (the kernel's registers allow one 512-thread block
    an SM either way)."""
    c = 1
    while c * 2 <= COLUMNS and ncols % (c * 2) == 0:
        c *= 2
    while c > 1 and sub_smem_bytes(m, c) > SMEM_BLOCK:
        c //= 2
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


def _launch_sub(src, dst, inverse: bool, K: int, m: int, ncols: int, inner: int,
                in_row: int, in_cq: int, out_row: int, out_cq: int, natural: bool,
                cross=None, cross_div: int = 1) -> None:
    """One launch of ``ntt_sub_kernel``: K x ncols columns of length m read
    from ``src`` and written to ``dst`` through the strides of
    csrc/ntt.cu::SubNtt (both hold K * m * ncols elements a limb plane)."""
    from . import ntt

    dev = check_cuda(src, dst)
    if m < 2 or m & (m - 1) or m > SUB_MAX_M:
        raise ValueError(f"sub-NTT length {m}")
    tw = ntt.stage_twiddles(m, inverse, dev)
    cols = _columns_per_block(m, ncols)
    if sub_smem_bytes(m, cols) > SMEM_BLOCK:
        raise ValueError(f"sub-NTT of length {m} does not fit a block's shared memory")
    launch("bpt_ntt_sub", dev, ptr(src), ptr(dst), ptr(tw), None if cross is None else ptr(cross),
           K, m, ncols, inner, in_row, in_cq, out_row, out_cq,
           0 if cross is None else cross.shape[-1], cross_div, cols, int(natural))
    ntt_sub.launches += 1


def ntt_sub(a: torch.Tensor, inverse: bool) -> torch.Tensor:
    """All log2(m) butterfly stages of a length-m Fr NTT along axis -2 of a
    (16, K, m, B) Montgomery batch (K and B are batch axes), output rows in
    BIT-REVERSED order, no 1/m scaling — the contract of
    ``ntt_sub_pallas`` (ops/pallas_kernels.py:355), with the batch axes the
    TPU kernel lacked. m <= SUB_MAX_M. ``launches`` counts kernel launches,
    those of ``ntt_sub_4step`` included."""
    from . import ntt

    L, K, m, B = a.shape
    if L != 16 or m & (m - 1) or m > SUB_MAX_M:
        raise ValueError(f"ntt_sub: bad shape {tuple(a.shape)}")
    if m == 1:
        return a
    if on_cpu(a):
        return ntt_sub_plain(a, ntt.sub_twiddles(m, inverse, a.device)).to(torch.int32)
    check_cuda(a)
    a = a.contiguous()
    out = torch.empty_like(a)
    _launch_sub(a, out, inverse, K, m, B, 1, B, 1, B, 1, natural=False)
    return out


ntt_sub.launches = 0


def _four_step_composed(a, inverse, sub_max, plain, scaled):
    """The four-step transform as a composition of separate passes: sub-NTT
    over m1 (lanes m2*B), bit-reversal row gather, cross-twiddle multiply by
    w^(j1*i2), transpose, sub-NTT over m2 (lanes m1*B), bit-reversal gather.
    The plain version of the two-launch path, the CPU's path, and the path of
    a factor above ``sub_max``, which recurses."""
    from . import limbs, ntt

    L, K, m, B = a.shape
    m1, m2, crossT, br1, br2 = ntt.plan4(m, inverse, a.device, scaled)

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
    # rows are (j2, j1): flattening gives index j1 + m1*j2, natural order
    return x.reshape(L, K, m, B)


def ntt_sub_4step(a: torch.Tensor, inverse: bool, sub_max: int | None = None,
                  plain: bool = False, scaled: bool = False) -> torch.Tensor:
    """Natural-order length-m Fr NTT along axis -2 of (16, K, m, B) as
    m = m1 x m2 (counterpart of ``ntt_sub_pallas_4step``,
    ops/pallas_kernels.py:402). No 1/m scaling unless ``scaled`` (an inverse
    transform then includes it: the plan folds 1/m into the cross twiddles).

    On a CUDA tensor two launches of the sub-NTT kernel: pass 1 transforms
    the m2*B strided columns of length m1 and stores row j1 in natural order
    times w^(j1*i2); pass 2 transforms the m1*B contiguous rows of length m2
    and stores element j2 of row j1 at j2*m1 + j1. ``launches`` counts
    transforms, ``ntt_sub.launches`` the kernel launches: 2 a transform. A
    factor above ``sub_max`` (default SUB_MAX_M) recurses through the
    composition of separate passes, which is also the CPU's path and, with
    ``plain``, the reference on the card; ``composed`` counts the transforms
    on the card that took it (2^22 = 2048 x 2048: counted once there and
    once for each of its two inner transforms, so 3 transforms and 4
    kernel launches)."""
    from . import ntt

    sub_max = SUB_MAX_M if sub_max is None else sub_max
    L, K, m, B = a.shape
    if m == 1:
        return a
    m1, m2 = ntt.split(m)
    if plain or on_cpu(a) or m2 > sub_max or m1 == 1:
        out = _four_step_composed(a, inverse, sub_max, plain, scaled)
        if not plain and not on_cpu(a):
            ntt_sub_4step.launches += 1
            ntt_sub_4step.composed += 1
        return out
    check_cuda(a)
    a = a.contiguous()
    cross = ntt.plan4(m, inverse, a.device, scaled)[2]
    mid = torch.empty_like(a)  # (16, K, m1, m2 * B): row j1, natural order, twiddled
    _launch_sub(a, mid, inverse, K, m1, m2 * B, 1, m2 * B, 1, m2 * B, 1, natural=True,
                cross=cross, cross_div=B)
    out = torch.empty_like(a)  # (16, K, m2, m1 * B): row j2
    _launch_sub(mid, out, inverse, K, m2, m1 * B, B, B, m2 * B, m1 * B, B, natural=True)
    ntt_sub_4step.launches += 1
    return out


ntt_sub_4step.launches = 0
ntt_sub_4step.composed = 0
