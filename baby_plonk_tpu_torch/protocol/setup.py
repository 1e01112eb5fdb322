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

``generate_srs_device`` computes the G1 powers on the device with the
powers-of-tau kernel (counterpart of ``Setup.generate_srs_device`` there,
:46-99); they stay on the device in ``Setup.device_points`` (keyed by
device) and ``powers_of_x`` stays None until ``materialize_host``. The
device SRS has no disk cache.
"""
from __future__ import annotations

import hashlib
import os
import pickle

import torch

from ..fields import fr
from ..fields.tower import Fp2
from ..curves.g1 import G1
from ..curves.g2 import G2
from ..curves import msm_host
from .poly import Basis, Poly

def _cache_dir() -> str:
    from ..config import get_config

    return get_config().srs_cache_dir


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

    def srs_len(self) -> int:
        return self.n_powers

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


def generate_srs_device(powers: int, tau: int, device="cuda") -> Setup:
    """SRS [tau^i G1]_{i < powers} computed on ``device`` by the
    powers-of-tau kernel, plus tau G2 on the host."""
    from ..ops import srs

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("generate_srs_device: no CUDA device is available")
    tau %= fr.Q
    setup = Setup(None, G2.generator() * tau, n_powers=powers)
    setup.device_points[str(device)] = srs.powers_of_tau_device(powers, tau, device)
    return setup
