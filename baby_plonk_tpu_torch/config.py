"""Central configuration of the port: the counterpart of
``baby_plonk_tpu/config.py``, with the same environment variables selecting
the same paths. The coset constants and the transcript's domain separator
are fixed by the protocol and live where they are used (protocol/prover.py,
protocol/verifier.py, protocol/transcript.py), not here.

Values come from environment variables at first access; callers may also
construct and install a Config explicitly (tests do).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class Config:
    #: "torch" (TorchEngine on the CUDA device), "mesh" (MeshEngine, the
    #: prover sharded over the cards) or "host" (exact Python oracle)
    engine: str = field(default_factory=lambda: os.environ.get("BPT_ENGINE", "torch"))
    #: directory for cached SRS pickles (protocol/setup.py)
    srs_cache_dir: str = field(
        default_factory=lambda: os.environ.get(
            "BPT_SRS_CACHE",
            os.path.join(os.path.expanduser("~"), ".cache", "baby_plonk_tpu_torch"),
        )
    )
    #: keep the reference's mid-pipeline invariant checks (z(w^n)=1,
    #: r(zeta)=0, exact-division remainders — prover.rs:319,615). They cost
    #: host syncs on the device path; disable for max-throughput production runs.
    debug_asserts: bool = field(
        default_factory=lambda: os.environ.get("BPT_DEBUG_ASSERTS", "1") != "0"
    )
    #: shards of the mesh engine (parallel/mesh.py::make_mesh; shard d on
    #: card d mod the card count); None = one per visible card
    mesh_devices: int | None = field(
        default_factory=lambda: (
            int(os.environ["BPT_MESH_DEVICES"])
            if os.environ.get("BPT_MESH_DEVICES")
            else None
        )
    )
    #: generic MSM algorithm: "bitserial" (default) or "pippenger"
    #: (sorted-bucket method, ops/msm_pippenger.py)
    msm_algorithm: str = field(
        default_factory=lambda: os.environ.get("BPT_MSM", "bitserial")
    )
    #: use precomputed fixed-base tables for KZG commits (ops/msm_fixed.py;
    #: 8x fewer point lanes than bitserial, tables cached per SRS).
    #: BPT_MSM_FIXED=0 selects the variable-base MSM (ops/msm.py).
    commit_fixed_base: bool = field(
        default_factory=lambda: os.environ.get("BPT_MSM_FIXED", "1") != "0"
    )


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def set_config(cfg: Config) -> None:
    global _config
    _config = cfg
