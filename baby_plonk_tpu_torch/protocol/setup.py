"""KZG trusted setup (toy: tau passed in) and polynomial commitment
(counterpart of ``baby_plonk_tpu/protocol/setup.py``).

Functional equivalent of src/setup.rs. The SRS is
  powers_of_x = [G1, tau*G1, ..., tau^(powers-1)*G1],  x_2 = tau*G2
(setup.rs:12-31). Unlike the reference's serial 255-bit scalar-mul chain,
we compute the scalar powers tau^i first (cheap field muls) and do
independent fixed-base multiplications — and cache generated SRS to disk
(the reference regenerates per run; SURVEY.md §5 checkpoint/resume gap).

``commit`` asserts monomial basis (setup.rs:34) and multi-scalar-multiplies
the coefficients against the SRS on the host (the exact oracle's commit).

``Setup.generate_srs_device`` computes the G1 powers on the device with the
powers-of-tau kernel (counterpart of ``Setup.generate_srs_device`` there,
:45-99); they stay on the device in ``Setup.device_points`` (keyed by
device) and ``powers_of_x`` stays None until ``materialize_host``. With
``cache=True`` the device SRS is kept as an ``.npz`` under
``Config.srs_cache_dir`` (key prefix ``srs-dev-torch-v1``: the port's own,
the JAX package's ``srs-dev-v2`` files hold another layout).
"""
from __future__ import annotations

import hashlib
import os
import pickle
import zipfile

import numpy as np
import torch

from ..fields import fr
from ..fields.tower import Fp2
from ..curves.g1 import G1
from ..curves.g2 import G2
from ..curves import msm_host
from .poly import Basis, Poly

#: key prefix of the device-SRS cache files
DEVICE_SRS_KEY = "srs-dev-torch-v1"


def _cache_dir() -> str:
    from ..config import get_config

    return get_config().srs_cache_dir


def device_srs_path(powers: int, tau: int) -> str:
    """The cache file of the device SRS of ``powers`` powers of ``tau``."""
    key = hashlib.sha256(f"{DEVICE_SRS_KEY}-{powers}-{tau % fr.Q}".encode()).hexdigest()[:24]
    return os.path.join(_cache_dir(), f"{key}.npz")


def _g2_bytes(pt: G2) -> bytes:
    """x_2 as the six 48-byte little-endian coordinates (x.c0, x.c1, y.c0,
    y.c1, z.c0, z.c1), as the JAX package writes it."""
    return b"".join(int(v).to_bytes(48, "little") for v in (pt.x.c0, pt.x.c1, pt.y.c0, pt.y.c1, pt.z.c0, pt.z.c1))


def _load_device_srs(path: str, powers: int):
    """((px, py, pz) numpy (24, powers) int32, x_2) from a cache file, or
    None where it is missing, unreadable or of the wrong shapes."""
    try:
        with np.load(path) as data:
            pts = tuple(data[k] for k in ("px", "py", "pz"))
            xb = data["x2"].tobytes()
    except (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile):
        return None
    if len(xb) != 6 * 48 or any(
        c.shape != (24, powers) or c.dtype != np.int32 or c.min() < 0 or c.max() > 0xFFFF for c in pts
    ):
        return None
    c = [int.from_bytes(xb[i * 48 : (i + 1) * 48], "little") for i in range(6)]
    return pts, G2(Fp2(c[0], c[1]), Fp2(c[2], c[3]), Fp2(c[4], c[5]))


def _save_device_srs(path: str, pts, x_2: G2) -> None:
    """Write the cache file atomically: a file of this process's own, then
    ``os.replace``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    px, py, pz = (c.cpu().numpy() for c in pts)
    np.savez(tmp, px=px, py=py, pz=pz, x2=np.frombuffer(_g2_bytes(x_2), dtype=np.uint8))
    os.replace(tmp, path)


class Setup:
    def __init__(self, powers_of_x: list[G1] | None, x_2: G2, n_powers: int | None = None):
        self.powers_of_x = powers_of_x
        self.x_2 = x_2
        self.n_powers = n_powers if n_powers is not None else len(powers_of_x or [])
        #: device SRS, str(device) -> (X, Y, Z) (24, n) Montgomery tensors
        #: (ops/srs.py::setup_points)
        self.device_points: dict = {}
        #: fixed-base commit tables, str(device) -> FixedBaseTables
        #: (ops/msm_fixed.py::tables_for_setup)
        self.fb_tables: dict = {}
        #: the SRS padded and sharded for a mesh, Mesh.key -> {"N", "points",
        #: "tables"} (parallel/mesh_engine.py::MeshEngine._mesh_srs)
        self.mesh_srs: dict = {}

    def srs_len(self) -> int:
        return self.n_powers

    @staticmethod
    def generate_srs_device(powers: int, tau: int, cache: bool = True, device="cuda") -> "Setup":
        """SRS [tau^i G1]_{i < powers} computed on ``device`` by the
        powers-of-tau kernel, plus tau G2 on the host. With ``cache`` the
        points and x_2 are read from ``device_srs_path(powers, tau)`` where a
        good file is there, else computed and written to it (a file that
        cannot be read or holds the wrong shapes is computed anew and
        overwritten)."""
        from ..ops import srs

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("generate_srs_device: no CUDA device is available")
        tau %= fr.Q
        path = device_srs_path(powers, tau) if cache else None
        loaded = _load_device_srs(path, powers) if path else None
        if loaded is not None:
            pts, x_2 = loaded
            setup = Setup(None, x_2, n_powers=powers)
            setup.device_points[str(device)] = tuple(torch.from_numpy(c).to(device) for c in pts)
            return setup
        setup = Setup(None, G2.generator() * tau, n_powers=powers)
        pts = setup.device_points[str(device)] = srs.powers_of_tau_device(powers, tau, device)
        if path:
            _save_device_srs(path, pts, setup.x_2)
        return setup

    @staticmethod
    def generate_srs(powers: int, tau: int, cache: bool = True) -> "Setup":
        tau = tau % fr.Q
        key = None
        if cache:
            key = hashlib.sha256(f"srs-v1-{powers}-{tau}".encode()).hexdigest()[:24]
            path = os.path.join(_cache_dir(), f"{key}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    xs, x2 = pickle.load(f)
                return Setup(
                    [G1(*t) for t in xs],
                    G2(Fp2(*x2[0]), Fp2(*x2[1]), Fp2(*x2[2])),
                )
        g = G1.generator()
        # powers of tau in the field (cheap), then one fixed-base mul each
        cur = 1
        pows: list[G1] = []
        base = g
        for i in range(powers):
            pows.append(base * cur if i > 0 else base)
            cur = cur * tau % fr.Q
        x_2 = G2.generator() * tau
        setup = Setup(pows, x_2)
        if cache and key is not None:
            os.makedirs(_cache_dir(), exist_ok=True)
            path = os.path.join(_cache_dir(), f"{key}.pkl")
            xs = [(p.x, p.y, p.z) for p in pows]
            x2s = [(x_2.x.c0, x_2.x.c1), (x_2.y.c0, x_2.y.c1), (x_2.z.c0, x_2.z.c1)]
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump((xs, x2s), f)
            os.replace(tmp, path)
        return setup

    def materialize_host(self) -> None:
        """Fill ``powers_of_x`` from the device SRS (one host batch
        inversion)."""
        if self.powers_of_x is None:
            from ..ops import g1_vec

            pts = next(iter(self.device_points.values()))
            self.powers_of_x = g1_vec.points_from_device(pts)

    def commit(self, polynomial: Poly) -> G1:
        """KZG commit: MSM of monomial coefficients against the SRS (setup.rs:32-37)."""
        assert polynomial.basis == Basis.MONOMIAL
        values = polynomial.values
        # the reference zip-truncates silently; we require the poly to fit
        nonzero_len = len(values)
        while nonzero_len and values[nonzero_len - 1] == 0:
            nonzero_len -= 1
        assert nonzero_len <= self.srs_len(), (
            f"polynomial degree {nonzero_len - 1} exceeds SRS size {self.srs_len()}"
        )
        self.materialize_host()
        return msm_host.msm(self.powers_of_x[:nonzero_len], values[:nonzero_len])

