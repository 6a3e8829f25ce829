"""Particle-axis sharding across processes, on ``torch.distributed``.

Port of ``phdslam_tpu/parallel/mesh.py``. JAX shards the particle axis over
a device mesh and lets XLA insert the collectives. Here the axis is split
over W processes (ranks), one device each: rank r holds rows [r P/W,
(r + 1) P/W) of every per-particle leaf of the state (``SlamState``,
``DisparityState``: every leaf leads with the particle axis), and every
rank loads the same measurements and holds the same replicated tensors.

The per-particle work (prediction, the CPHD births, every measurement
update and its kernels) runs on the rank's rows and touches no other rank.
A step's global points (the weight normalisation, nEff, the expected pose,
the resample and ``log_aux``'s MAP particle) need the other ranks' rows,
which ``gather_rows`` brings: [n, ...] on each rank in, [W n, ...] in rank
order on every rank out. Each rank then computes the global values exactly
as the single process does from the same gathered tensors and keeps its
own rows, so a sharded step equals the single-process step bit for bit. A
max/sum all-reduce of the logsumexp would not: its partial sums round
otherwise than a logsumexp over [P].

Particle maps move only where the JAX package moves them. JAX gates the
resample with ``lax.cond`` and XLA's map-sized gather runs inside it, on
the steps whose resample fires; the island butterfly runs under
``lax.cond`` too, as static-stride ``ppermute``s of one island's shard.
PyTorch enqueues NCCL and gloo collectives from the host, so a transfer
can be skipped on a device-side predicate only after the host has read
it: ``read_flag`` is that read, the one a sharded step makes (every rank
computes the predicate from the same gathered tensors; the ranks' values
are compared and a disagreement raises). A resample that fires gathers
every leaf of the state on every rank and takes the rows its slice of the
global indices names; one that does not fire moves no map. The butterfly
across ranks swaps shards between partner ranks through ``exchange_rows``
(one two-rank group per pair {r, r ^ m}, made once by every rank in the
same order, as ``dist.new_group`` needs).

Every transfer through ``gather_rows``, ``global_row`` and
``exchange_rows`` and every ``read_flag`` adds to the mesh's traffic
record under the caller's label (``take_traffic``): calls, the bytes this
rank offered, the bytes it received from other ranks and its largest
block.

Random draws: every rank draws the global step's draws from a generator
seeded alike (or replays given global draws) and slices its rows, so a
sharded run filters the single-process run's draws.

Every transfer is ``all_gather_into_tensor`` under either backend, over
all ranks or within a pair's group: NCCL on the card, gloo on the CPU, and
gloo for CUDA tensors (ranks that share one card, which NCCL refuses:
"Duplicate GPU detected"), which stages them through the host. PyTorch
2.11 on an H100 was checked to take a CUDA all-gather under gloo.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass
class ParticleMesh:
    """The particle axis over ``world_size`` ranks: this process's rank,
    its process group (None: the default group), the backend, the rank's
    device, its pair groups (partner rank -> the two ranks' group) and the
    traffic record (``note``, ``take_traffic``)."""

    rank: int
    world_size: int
    group: Any
    backend: str
    device: torch.device
    pairs: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)

    def local(self, x, dim: int = 0):
        """This rank's block of x along dim: [r n/W, (r + 1) n/W), a view."""
        n = x.shape[dim]
        self.check_divides(n, "the sharded axis")
        per = n // self.world_size
        return x.narrow(dim, self.rank * per, per)

    def check_divides(self, n: int, what: str):
        if n % self.world_size:
            raise ValueError(f"{what} ({n}) is not a multiple of the "
                             f"mesh's {self.world_size} ranks")

    def note(self, op: str, label: str, offered: int, received: int):
        """One transfer into the record under "op label": this rank's
        block of ``offered`` bytes, ``received`` bytes from other ranks."""
        r = self.traffic.setdefault(f"{op} {label}", dict(
            calls=0, offered=0, received=0, largest=0))
        r["calls"] += 1
        r["offered"] += offered
        r["received"] += received
        r["largest"] = max(r["largest"], offered)

    def take_traffic(self) -> dict:
        """The record since the last take ({"op label": {calls, offered,
        received, largest}}, bytes), and a fresh one."""
        out, self.traffic = self.traffic, {}
        return out

    def close(self):
        """Destroy the process group and the pair groups (every rank calls
        it)."""
        self.pairs = {}
        dist.destroy_process_group(self.group)


def make_mesh(backend: Optional[str] = None, device=None, *,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              init_method: Optional[str] = None) -> ParticleMesh:
    """Join (or start) the process group and return this rank's mesh.

    rank, world_size: torchrun's ``RANK`` and ``WORLD_SIZE`` unless given;
    init_method: ``env://`` (torchrun's ``MASTER_ADDR``/``MASTER_PORT``)
    unless given, e.g. ``file:///tmp/x`` or ``tcp://localhost:PORT``.
    device: ``cuda:{LOCAL_RANK}`` by default, and then NCCL; ``cpu``
    selects gloo on the CPU; ``backend="gloo"`` on a CUDA device is for
    ranks that share one card. Without CUDA, and not asked for the CPU,
    it raises. Every rank makes the pair groups {r, r ^ m}, m = 1, 2, 4,
    ... below W, in the same order."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else int(world_size)
    device = torch.device(f"cuda:{int(env.get('LOCAL_RANK', 0))}"
                          if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: device {device} but CUDA is not "
                               "available; pass device='cpu' for gloo on "
                               "the CPU")
        if device.index is None:
            device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"make_mesh: device {device} is neither cuda nor "
                         "cpu")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: backend {backend!r} is neither nccl "
                         "nor gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("make_mesh: NCCL needs a CUDA device")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"make_mesh: the process group's backend is "
                           f"{dist.get_backend()}, not {backend}")
    rank, world = dist.get_rank(), dist.get_world_size()
    pairs, m = {}, 1
    while m < world:
        for a in range(world):
            b = a ^ m
            if a < b < world:
                group = dist.new_group([a, b])
                if rank in (a, b):
                    pairs[a + b - rank] = group
        m *= 2
    return ParticleMesh(rank=rank, world_size=world, group=None,
                        backend=backend, device=device, pairs=pairs)


def _all_gather(x, group, size: int):
    """[n, ...] on each of the group's ``size`` ranks -> [size n, ...] in
    group-rank order."""
    x = x.contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    if x.numel():               # a [P, 0] map: nothing to move
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def gather_rows(x, mesh: ParticleMesh, label: str = "rows"):
    """[n, ...] on each rank -> [W n, ...] on every rank, rank r's rows in
    block r."""
    out = _all_gather(x, mesh.group, mesh.world_size)
    mesh.note("gather_rows", label, _nbytes(x),
              _nbytes(x) * (mesh.world_size - 1))
    return out


def exchange_rows(x, partner: int, mesh: ParticleMesh, label: str):
    """Rank ``partner``'s [n, ...] block for this rank's x (the counterpart
    of ``lax.ppermute`` at one stride): both ranks call it with blocks of
    one shape, through their pair's group."""
    group = mesh.pairs.get(partner)
    if group is None:
        raise ValueError(f"exchange_rows: rank {mesh.rank} has no pair "
                         f"group with rank {partner}")
    both = _all_gather(x, group, 2)
    mesh.note("exchange_rows", label, _nbytes(x), _nbytes(x))
    n = x.shape[0]
    return both[n:] if partner > mesh.rank else both[:n]


def read_flag(t, mesh: ParticleMesh, label: str) -> bool:
    """A replicated 0-d bool as a Python bool: the one read of the device
    in a sharded step, so that a transfer gated on it can be skipped
    (``lax.cond``'s counterpart). Raises unless every rank holds the same
    value."""
    flag = t.reshape(1).to(torch.int32)
    flags = _all_gather(flag, mesh.group, mesh.world_size).tolist()
    mesh.note("read_flag", label, _nbytes(flag),
              _nbytes(flag) * (mesh.world_size - 1))
    if min(flags) != max(flags):
        raise RuntimeError(f"read_flag {label}: the ranks disagree "
                           f"({flags})")
    return bool(flags[0])


def everywhere(mesh: Optional[ParticleMesh], label: str = "rows"):
    """(gather, own): a rank's rows -> the global tensor (``gather_rows``
    under label), the global tensor -> the rank's rows; both the identity
    without a mesh, so one code path serves the single process and the
    ranks."""
    if mesh is None:
        return (lambda t: t), (lambda t: t)
    return (lambda t: gather_rows(t, mesh, label)), mesh.local


def global_row(x, idx, mesh: ParticleMesh, label: str = "row"):
    """Row ``idx`` (a 0-d index tensor into the global [P] axis, the same on
    every rank) of the sharded leaf x, on every rank: each rank offers the
    row it would hold there (clamped into its block), the W offers are
    gathered, and the owner's is kept. No host read."""
    p = x.shape[0]
    mine = x.index_select(0, torch.clamp(idx - mesh.rank * p, 0,
                                         p - 1).reshape(1))
    owner = torch.div(idx, p, rounding_mode="floor").reshape(1)
    out = _all_gather(mine, mesh.group, mesh.world_size)
    mesh.note("global_row", label, _nbytes(mine),
              _nbytes(mine) * (mesh.world_size - 1))
    return out.index_select(0, owner)[0]


def pack_rows(tree):
    """Every leaf of a tensor tree (``SlamState``; each leaf [n, ...] of a
    4-byte dtype) as the columns of one int32 [n, words] tensor, and the
    function that unpacks such a tensor (any row count) into the tree's
    structure, bit for bit."""
    leaves = []
    tree.map(lambda t: leaves.append(t) or t)
    if any(t.element_size() != 4 for t in leaves):
        raise ValueError("pack_rows: every leaf must be 4 bytes wide")
    n = leaves[0].shape[0]
    widths = [math.prod(t.shape[1:]) for t in leaves]
    packed = torch.cat([t.reshape(n, w).view(torch.int32)
                        for t, w in zip(leaves, widths)], 1)

    def unpack(rows):
        parts = iter(torch.split(rows, widths, 1))
        return tree.map(lambda t: next(parts).contiguous().view(t.dtype)
                        .reshape((rows.shape[0],) + tuple(t.shape[1:])))

    return packed, unpack


def shard_state(state, mesh: ParticleMesh):
    """This rank's rows of every leaf of a global state (``SlamState`` or
    ``DisparityState``), copied onto the rank's device. W must divide the
    particle count."""
    mesh.check_divides(state.n_particles, "the particle count")
    return state.map(lambda t: mesh.local(t).to(mesh.device, copy=True))


def unshard_state(state, mesh: ParticleMesh, label: str = "state"):
    """The global state on every rank (the resample's gather, logs,
    tests)."""
    return state.map(lambda t: gather_rows(t, mesh, label))


def replicate_measurements(z, mesh: ParticleMesh):
    """The same Measurements on every rank's device (every rank loads the
    same data)."""
    return z.to(mesh.device)


def _check_cfg(cfg, mesh: ParticleMesh):
    mesh.check_divides(cfg.n_particles, "n_particles")


def sharded_step(cfg, mesh: ParticleMesh):
    """``slam_step`` with the particle axis over the mesh: step(state,
    control, z, dt, do_predict, **kw) on the rank's P/W rows, kw as
    ``slam_step``'s (generator, noise, with_variance, z_prev)."""
    from phdslam_tpu_torch.filter.step import slam_step
    _check_cfg(cfg, mesh)

    def step(state, control, z, dt, do_predict, **kw):
        return slam_step(state, control, z, dt, do_predict, cfg, mesh=mesh,
                         **kw)

    return step


def sharded_run_scan(cfg, mesh: ParticleMesh, with_log_state: bool = False):
    """``run_scan`` with the particle axis over the mesh (its semantics:
    the same steps, global normalisation and resample): run(state,
    controls, zs, dts, **kw), kw as ``run_scan``'s (generator, noises,
    with_variance); the stacked LogAux holds the global per-particle
    values."""
    from phdslam_tpu_torch.filter.step import run_scan
    _check_cfg(cfg, mesh)

    def run(state, controls, zs, dts, **kw):
        return run_scan(state, controls, zs, dts, cfg,
                        with_log_state=with_log_state, mesh=mesh, **kw)

    return run


def sharded_disparity_step(cfg, mesh: ParticleMesh):
    """``disparity_step`` with the particle axis over the mesh: step(state,
    z, dt, do_predict, **kw), kw as ``disparity_step``'s (generator,
    noise); the clouds [P, F, Npp] move through ``gather_rows`` like every
    other leaf."""
    from phdslam_tpu_torch.filter.disparity import disparity_step
    _check_cfg(cfg, mesh)

    def step(state, z, dt, do_predict, **kw):
        return disparity_step(state, z, dt, do_predict, cfg, mesh=mesh, **kw)

    return step
