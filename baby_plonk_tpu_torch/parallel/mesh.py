"""The device mesh of the sharded prover (counterpart of
``baby_plonk_tpu/parallel/mesh.py``).

A mesh is D shards of the prover's tensors, shard d holding block d of D
equal blocks of an axis (the JAX package's ``P(..., "shard")`` placement).
Every collective the sharded modules use is a method of the mesh, so
``dntt``, ``dmsm``, ``dscan`` and ``mesh_engine`` have one code path over
both kinds:

  * ``Mesh``: one process holds all D shards, shard d on ``devices[d]``,
    and the collectives are copies between them: peer copies over NVLink
    between two cards, copies within a card where several shards share one.
    Copies go through ``Tensor.to``, which orders a copy between two cards
    against the current streams of both, so a kernel launched on either
    stream before or after sees the copy complete.
  * ``ProcessMesh``: the D shards spread over the P processes of a
    ``torch.distributed`` group (the JAX package's multi-controller mesh
    after ``jax.distributed.initialize``). Process p holds shards
    p D/P .. (p+1) D/P - 1, all on its one device; chunks between shards of
    one process stay copies, and what crosses processes goes in one
    collective a call.

A mesh's shard lists hold this process's shards only, in the order of
``ids``, their global indices (``range(D)`` on a ``Mesh``); ``D`` is the
global shard count.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

#: the name of the mesh's one axis (the JAX package's ``parallel/mesh.py::AXIS``)
AXIS = "shard"


class Mesh:
    """D shards over ``devices`` (D entries; a device may repeat)."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.D = len(self.devices)
        #: global indices of the shards this process holds
        self.ids = range(self.D)
        #: the processes over the shards, and this one's rank
        self.P, self.rank = 1, 0
        #: collectives that crossed processes, and the bytes this process sent through them
        self.stats = {"collectives": 0, "bytes": 0}
        #: where the unsharded state lives between the engine's calls
        self.home = self.devices[0]
        #: distinct devices under this process's shards
        self.physical = len(set(self.devices))
        #: what the sharded caches are keyed by: equal for equal placements
        self.key = tuple(str(d) for d in self.devices)

    def __repr__(self):
        return f"Mesh(D={self.D}, physical={self.physical}, devices={list(self.key)})"

    def shard(self, x: torch.Tensor) -> list[torch.Tensor]:
        """This process's blocks of the last axis of ``x`` (D equal blocks;
        ``x`` holds the same values in every process), block d on its shard's
        device."""
        n = x.shape[-1]
        if n % self.D:
            raise ValueError(f"mesh: length {n} is no multiple of {self.D} shards")
        blocks = x.split(n // self.D, dim=-1)
        return [blocks[d].to(dev).contiguous() for d, dev in zip(self.ids, self.devices)]

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

    def agree(self, values: list[int]) -> list[int]:
        """The values every process of the mesh uses (one process: its own)."""
        return values


class ProcessMesh(Mesh):
    """D shards over the P processes of the default ``torch.distributed``
    group; this process holds shards ``ids`` = p D/P .. (p+1) D/P - 1, all
    on ``device``. Inputs to ``shard`` are replicated in every process and
    ``gather`` gives the whole tensor in every process, so the host half of
    the prover (transcript, challenges, rounds 4 and 5 on ``home``) runs in
    every process on equal values.

    The backend is the group's. ``nccl`` moves CUDA tensors directly (one
    process a card: ``placement`` refuses two ranks on one card). ``gloo``
    moves CPU tensors; CUDA shards are staged through host memory inside
    each collective: ``Tensor.cpu()`` copies on the shard's current stream
    behind the kernels that made it and returns when the copy is done, and
    the received bytes go back with ``Tensor.to``, ahead of the kernels
    launched after. The kernels run on the card either way; only the bytes
    in flight pass through the host.

    Every collective that crosses processes waits at most the group's
    timeout."""

    def __init__(self, device, D: int):
        P, rank = dist.get_world_size(), dist.get_rank()
        if D % P:
            raise ValueError(f"mesh: {D} shards over {P} processes: D must be a multiple of P")
        local = D // P
        super().__init__([device] * local)
        self.D, self.P, self.rank = D, P, rank
        self.ids = range(rank * local, (rank + 1) * local)
        self.backend = dist.get_backend()
        self.staged = self.backend == "gloo" and self.home.type == "cuda"
        self.key = (f"rank {rank} of {P}", f"D {D}", *self.key)

    def __repr__(self):
        return (f"ProcessMesh(D={self.D}, rank={self.rank} of {self.P}, shards {list(self.ids)} on "
                f"{self.home}, {self.backend}{' staged through the host' if self.staged else ''})")

    def _owner(self, d: int) -> int:
        return d // len(self.devices)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend takes it: on the host under ``gloo``."""
        return t.cpu() if self.staged else t.contiguous()

    def _counted(self, nbytes: int) -> None:
        self.stats["collectives"] += 1
        self.stats["bytes"] += nbytes

    def _exchange(self, send: torch.Tensor, send_rows: list[int], recv_rows: list[int]) -> torch.Tensor:
        """One ``all_to_all``: rows ``send_rows[q]`` of ``send`` (in order,
        by destination process) go to process q, and the result holds the
        rows from every process in rank order, ``recv_rows[q]`` from q, on
        ``home``. Rows to and from this process are zero: local chunks stay
        copies."""
        send = self._wire(send)
        out = send.new_empty((sum(recv_rows),) + tuple(send.shape[1:]))
        dist.all_to_all_single(out, send, output_split_sizes=recv_rows, input_split_sizes=send_rows)
        self._counted(send.nbytes)
        return out.to(self.home)

    def gather(self, shards) -> torch.Tensor:
        local = super().gather(shards)
        wire = self._wire(local)
        parts = [torch.empty_like(wire) for _ in range(self.P)]
        dist.all_gather(parts, wire)
        self._counted(wire.nbytes * (self.P - 1))
        return torch.cat(parts, dim=-1).to(self.home)

    def all_gather(self, shards) -> list[torch.Tensor]:
        full = self.gather(shards)
        return [full.to(dev) for dev in self.devices]

    def all_to_all(self, shards, split_axis: int, concat_axis: int) -> list[torch.Tensor]:
        local, D = len(self.devices), self.D
        if shards[0].shape[split_axis] % D:
            raise ValueError(f"all_to_all: axis of {shards[0].shape[split_axis]} in {D} chunks")
        parts = [s.chunk(D, dim=split_axis) for s in shards]  # parts[e][j]: local sender e, global receiver j
        others = [q for q in range(self.P) if q != self.rank]
        # by destination process q: chunk j of every local sender, for each j that q holds
        send = torch.stack([parts[e][j] for q in others for e in range(local)
                            for j in range(q * local, (q + 1) * local)])
        rows = [0 if q == self.rank else local * local for q in range(self.P)]
        recv = self._exchange(send, rows, rows).reshape(len(others), local, local, *send.shape[1:])
        out = []
        for j_local, j in enumerate(self.ids):
            chunks = []
            for q in range(self.P):  # senders in global order
                for e in range(local):
                    chunks.append(parts[e][j] if q == self.rank else recv[others.index(q), e, j_local])
            out.append(torch.cat(chunks, dim=concat_axis))
        return out

    def ppermute(self, shards, source) -> list[torch.Tensor]:
        local, me = len(self.devices), self.rank
        first = me * local
        if all(self._owner(source(d)) == self._owner(d) for d in range(self.D)):
            return [shards[source(d) - first].to(dev) for d, dev in zip(self.ids, self.devices)]
        # to process q, in its receivers' order: the shards of this process they read
        send, send_rows = [], []
        for q in range(self.P):
            wanted = [] if q == me else [source(d) - first for d in range(q * local, (q + 1) * local)
                                         if self._owner(source(d)) == me]
            send += [shards[i] for i in wanted]
            send_rows.append(len(wanted))
        recv_rows = [0 if q == me else sum(self._owner(source(d)) == q for d in self.ids) for q in range(self.P)]
        if send:
            buf = torch.stack(send)
        else:  # this process sends nothing, but takes part in the exchange
            buf = shards[0].new_empty((0,) + tuple(shards[0].shape))
        recv = self._exchange(buf, send_rows, recv_rows)
        offset = {q: sum(recv_rows[:q]) for q in range(self.P)}
        out = []
        for d, dev in zip(self.ids, self.devices):
            q = self._owner(source(d))
            if q == me:
                out.append(shards[source(d) - first].to(dev))
            else:
                out.append(recv[offset[q]].to(dev))
                offset[q] += 1
        return out

    def agree(self, values: list[int]) -> list[int]:
        """Rank 0's ``values`` (ints below 2^256) in every process: one
        broadcast."""
        buf = torch.tensor(list(b"".join(v.to_bytes(32, "little") for v in values)), dtype=torch.uint8)
        wire = buf if self.backend == "gloo" else buf.to(self.home)
        dist.broadcast(wire, src=0)
        self._counted(wire.nbytes if self.rank == 0 else 0)
        raw = bytes(wire.cpu().tolist())
        return [int.from_bytes(raw[32 * i: 32 * i + 32], "little") for i in range(len(values))]


def placement(device, backend: str, rank: int, world: int, cards: int | None = None) -> torch.device:
    """The device of process ``rank`` of ``world`` in a process mesh: the CPU
    when ``device`` is the CPU, else card LOCAL_RANK mod the card count
    (rank mod the count without LOCAL_RANK). Raises, before any collective,
    for a placement the backend refuses: ``nccl`` moves CUDA tensors only,
    and NCCL refuses two ranks of one communicator on one card."""
    device = torch.device(device)
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend moves CUDA tensors only: use gloo on the CPU")
        return device
    if device.type != "cuda":
        raise ValueError(f"placement: device type {device.type!r}: expected 'cuda' or 'cpu'")
    cards = torch.cuda.device_count() if cards is None else cards
    if cards < 1:
        raise RuntimeError("placement(device='cuda'): no CUDA device is available")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if backend == "nccl" and local_world > cards:
        raise ValueError(f"nccl needs one process a card: {local_world} processes on {cards} card(s) "
                         "would put two ranks of one communicator on one card; use gloo")
    return torch.device("cuda", local_rank % cards)


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh of ``n_devices`` shards (default: ``Config.mesh_devices``).

    In a process of an initialized ``torch.distributed`` group of P > 1
    processes, the ``ProcessMesh`` over it (D defaults to P and must be a
    multiple of it; this process's device from ``placement``). Otherwise
    one process holds every shard: on the card shard d lies on card d mod
    the card count (default: one shard a visible card), so D shards fit any
    number of cards; on the CPU every shard lies on the CPU (the tests).
    Raises without a card unless the CPU is asked for."""
    from ..config import get_config

    device = torch.device(device)
    if n_devices is None:
        n_devices = get_config().mesh_devices
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        P, rank = dist.get_world_size(), dist.get_rank()
        return ProcessMesh(placement(device, dist.get_backend(), rank, P), n_devices or P)
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
