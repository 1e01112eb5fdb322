"""The device mesh of the sharded prover (counterpart of
``baby_plonk_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process holds a 1-D
``jax.sharding.Mesh`` and every sharded function is a ``shard_map`` over
it, its collectives XLA's. Here one process holds D shard tensors, shard d
on ``devices[d]``, and the collectives are copies between them: peer
copies over NVLink between two cards, copies within a card where several
shards share one. A shard is always the same block of an axis: block d of
D equal blocks (the JAX package's ``P(..., "shard")`` placement).

Copies go through ``Tensor.to``, which orders a copy between two cards
against the current streams of both, so a kernel launched on either
stream before or after sees the copy complete. Every collective is a
method of ``Mesh``: a process-group backend can take their place later.
"""
from __future__ import annotations

import torch

#: the name of the mesh's one axis (the JAX package's ``parallel/mesh.py::AXIS``)
AXIS = "shard"


class Mesh:
    """D shards over ``devices`` (D entries; a device may repeat)."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.D = len(self.devices)
        #: where the unsharded state lives between the engine's calls
        self.home = self.devices[0]
        #: distinct devices under the D shards
        self.physical = len(set(self.devices))
        #: what the sharded caches are keyed by: equal for equal placements
        self.key = tuple(str(d) for d in self.devices)

    def __repr__(self):
        return f"Mesh(D={self.D}, physical={self.physical}, devices={list(self.key)})"

    def shard(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The last axis of ``x`` in D equal blocks, block d on devices[d]."""
        n = x.shape[-1]
        if n % self.D:
            raise ValueError(f"mesh: length {n} is no multiple of {self.D} shards")
        return [b.to(dev).contiguous() for b, dev in zip(x.split(n // self.D, dim=-1), self.devices)]

    def gather(self, shards) -> torch.Tensor:
        """The blocks concatenated on the last axis, on ``home``."""
        return torch.cat([s.to(self.home) for s in shards], dim=-1)

    def all_gather(self, shards) -> list[torch.Tensor]:
        """``gather`` on every device: entry d is the concatenation on devices[d]."""
        return [torch.cat([s.to(dev) for s in shards], dim=-1) for dev in self.devices]

    def all_to_all(self, shards, split_axis: int, concat_axis: int) -> list[torch.Tensor]:
        """``jax.lax.all_to_all(..., tiled=True)``: every shard splits its
        ``split_axis`` into D chunks and sends chunk j to shard j, which
        concatenates the chunks it receives, in the order of their senders,
        on ``concat_axis``."""
        parts = [s.chunk(self.D, dim=split_axis) for s in shards]
        return [torch.cat([parts[e][j].to(dev) for e in range(self.D)], dim=concat_axis)
                for j, dev in enumerate(self.devices)]

    def ppermute(self, shards, source) -> list[torch.Tensor]:
        """Entry d is shard ``source(d)``, on devices[d]."""
        return [shards[source(d)].to(dev) for d, dev in enumerate(self.devices)]


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh of ``n_devices`` shards (default: ``Config.mesh_devices``,
    else one per visible card; one on the CPU). On the card shard d lies on
    card d mod the card count, so D shards fit any number of cards; on the
    CPU every shard lies on the CPU (the tests). Raises without a card
    unless the CPU is asked for."""
    from ..config import get_config

    device = torch.device(device)
    if n_devices is None:
        n_devices = get_config().mesh_devices
    if device.type == "cpu":
        return Mesh([device] * (n_devices or 1))
    if device.type != "cuda":
        raise ValueError(f"make_mesh: device type {device.type!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda'): no CUDA device is available")
    cards = torch.cuda.device_count()
    D = cards if n_devices is None else n_devices
    if D < 1:
        raise ValueError(f"make_mesh: {D} shards")
    return Mesh([torch.device("cuda", d % cards) for d in range(D)])
