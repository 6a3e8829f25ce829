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
and every transfer between ranks goes through ``gather_rows``: [n, ...] on
each rank in, [W n, ...] in rank order on every rank out. Each rank then
computes the global values exactly as the single process does from the
same gathered tensors and keeps its own rows, so a sharded step equals the
single-process step bit for bit. A max/sum all-reduce of the logsumexp
would not: its partial sums round otherwise than a logsumexp over [P].

The resample moves whole maps: every rank gathers every leaf of the state
and takes the rows its slice of the global indices names, on every step
(the trigger stays on the device, as in the single process).

Random draws: every rank draws the global step's draws from a generator
seeded alike (or replays given global draws) and slices its rows, so a
sharded run filters the single-process run's draws.

The transfer is ``all_gather_into_tensor`` under either backend: NCCL
on the card, gloo on the CPU, and gloo for CUDA tensors (ranks that share
one card, which NCCL refuses: "Duplicate GPU detected"), which stages them
through the host. PyTorch 2.11 on an H100 was checked to take a CUDA
all-gather under gloo.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass
class ParticleMesh:
    """The particle axis over ``world_size`` ranks: this process's rank,
    its process group (None: the default group), the backend and the
    rank's device."""

    rank: int
    world_size: int
    group: Any
    backend: str
    device: torch.device

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

    def close(self):
        """Destroy the process group (every rank calls it)."""
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
    it raises."""
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
    return ParticleMesh(rank=dist.get_rank(),
                        world_size=dist.get_world_size(), group=None,
                        backend=backend, device=device)


def gather_rows(x, mesh: ParticleMesh):
    """[n, ...] on each rank -> [W n, ...] on every rank, rank r's rows in
    block r. The one place where rows cross ranks."""
    x = x.contiguous()
    shape = (mesh.world_size * x.shape[0],) + tuple(x.shape[1:])
    if x.numel() == 0:          # a [P, 0] map: nothing to move
        return x.new_empty(shape)
    out = x.new_empty(shape)
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out


def everywhere(mesh: Optional[ParticleMesh]):
    """(gather, own): a rank's rows -> the global tensor (``gather_rows``),
    the global tensor -> the rank's rows; both the identity without a
    mesh, so one code path serves the single process and the ranks."""
    if mesh is None:
        return (lambda t: t), (lambda t: t)
    return (lambda t: gather_rows(t, mesh)), mesh.local


def global_row(x, idx, mesh: ParticleMesh):
    """Row ``idx`` (a 0-d index tensor into the global [P] axis, the same on
    every rank) of the sharded leaf x, on every rank: each rank offers the
    row it would hold there (clamped into its block), the W offers are
    gathered, and the owner's is kept. No host read."""
    p = x.shape[0]
    mine = torch.clamp(idx - mesh.rank * p, 0, p - 1).reshape(1)
    owner = torch.div(idx, p, rounding_mode="floor").reshape(1)
    return gather_rows(x.index_select(0, mine), mesh).index_select(0,
                                                                   owner)[0]


def shard_state(state, mesh: ParticleMesh):
    """This rank's rows of every leaf of a global state (``SlamState`` or
    ``DisparityState``), copied onto the rank's device. W must divide the
    particle count."""
    mesh.check_divides(state.n_particles, "the particle count")
    return state.map(lambda t: mesh.local(t).to(mesh.device, copy=True))


def unshard_state(state, mesh: ParticleMesh):
    """The global state on every rank (for logs and tests)."""
    return state.map(lambda t: gather_rows(t, mesh))


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
