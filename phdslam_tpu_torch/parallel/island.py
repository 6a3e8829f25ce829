"""The island particle model with butterfly weight balancing, on one device.

Port of ``phdslam_tpu/parallel/island.py``. JAX shards the particle axis
over a mesh, one island a device. Here the n islands are n blocks of the
particle axis of one state, the layout of the Monte-Carlo run axis
(``filter/runs.py``): island k holds rows [k P/n, (k + 1) P/n), P =
``cfg.n_particles``, the global count. One step:

  - every island runs the SLAM step on its own block, with its own local
    normalisation, nEff and stratified resample: one ``slam_step`` at
    ``n_particles = P / n`` over n runs, so every kernel launches once
    for all P rows;
  - island k's log-weight gains its local normaliser (its marginal
    likelihood increment) and the island weights are normalised across
    islands; their logsumexp is the global log-likelihood; the island nEff
    is ``1 / (n sum exp(2 ilw))``; the expected pose is the island-weighted
    sum of the islands' expected poses, taken before the exchange;
  - when the island nEff is at or below the threshold, a butterfly
    exchange: at strides 1, 2, 4, ..., island k pools its P/n particles
    with island k ^ stride's, weighted by island weight + local weight,
    resamples P/n of the 2P/n, and both take the pair's mean island
    weight.

The one measurement set reaches the islands as n identical per-run sets
(``expand`` + ``contiguous``: n x M x 2 floats a step). That is the run
axis's own path, which its tests hold against single runs bit for bit;
a shared set with a separate run count would be a second path through
``slam_step`` for the same numbers.

JAX gates the exchange with ``lax.cond`` on a traced predicate. On one
device the trigger stays on the device: every round is computed each
step, the rounds' index maps are composed, and ``torch.where`` picks the
composed map or the identity, the weights, the lineage and the island
weights before the one gather of the state. That step never reads the
device.

The draws come from one generator (``draw_island_noise``): pose normals
[sub, P, d], the islands' resample uniforms [P] and the butterfly's
uniforms [rounds, P], island k's in its block of each. ``noise=`` replays
given draws (the tests replay JAX's per-island keys).

Across ranks (``mesh``, ``parallel/mesh.py``; JAX puts one island on each
mesh device): W ranks, W dividing n, rank r holding the q = n/W islands
[r q, (r + 1) q). Each rank runs its local ``slam_step`` over its q
islands, each per-island reduction taken as among all n
(``layout_runs``), so that it rounds as on one device. The island
weights, the island nEff, the global log-likelihood and the expected pose
come from the gathered [n] log-likelihoods and [n, 6] expected poses, the
same on every rank (every rank keeps all n island weights). The trigger
is read once (``read_flag``); a step that does not exchange moves nothing
more. One that does runs ``butterfly_ranks``: a round at stride s < q
pairs islands of one rank and is computed there; a round at s >= q pairs
each island with the one at the same local position on rank r ^ (s / q),
and the two ranks swap their shard once (``exchange_rows``, JAX's
``ppermute``), log2(W) shards a rank per exchange, never a global gather.
Every rank draws the global draws and uses its islands' rows, so the step
equals the one-device step bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from phdslam_tpu_torch.filter.predict import noise_dim
from phdslam_tpu_torch.filter.state import Measurements, SlamState
from phdslam_tpu_torch.filter.step import slam_step
from phdslam_tpu_torch.ops.resample import stratified_resample_indices
from phdslam_tpu_torch.parallel.mesh import (everywhere, exchange_rows,
                                             pack_rows, read_flag)


class IslandAux(NamedTuple):
    expected_pose: torch.Tensor   # [6] global (island-weighted)
    island_logw: torch.Tensor     # [n] normalised island log-weights
    island_neff: torch.Tensor     # scalar in (0, 1]: nEff(islands) / n
    exchanged: torch.Tensor       # bool: the butterfly ran this step
    log_lik: torch.Tensor         # scalar global marginal-likelihood incr.


class IslandLogAux(NamedTuple):
    """What the island scan mode's state_estimate logs need: each island's
    local MAP particle's map ([n, F]) and its score; the host picks the
    island with the largest score."""

    best_score: torch.Tensor      # [n] island_logw + max local particle lw
    best_w: torch.Tensor          # [n, F] that particle's static channels
    best_mx: torch.Tensor
    best_my: torch.Tensor
    best_c00: torch.Tensor
    best_c01: torch.Tensor
    best_c11: torch.Tensor
    log_weights: torch.Tensor     # [P] global log weights (island + local)
    poses: torch.Tensor           # [P, 6]
    resample_idx: torch.Tensor    # [P]


def butterfly_strides(n_islands: int) -> list:
    """The exchange's strides 1, 2, 4, ... below n_islands."""
    out, s = [], 1
    while s < n_islands:
        out.append(s)
        s *= 2
    return out


def check_islands(cfg, n_islands: int, mesh=None):
    """JAX's preconditions, as ValueError: n a power of 2 that divides the
    global particle count, and no shotgun expansion (it would change the
    islands' shapes); with a mesh, its ranks dividing n."""
    n = int(n_islands)
    if mesh is not None:
        mesh.check_divides(n, "n_islands")
    if n < 1 or n & (n - 1):
        raise ValueError(f"n_islands must be a power of 2, got {n}")
    if cfg.n_particles % n:
        raise ValueError(f"n_particles {cfg.n_particles} is not a multiple "
                         f"of n_islands {n}")
    if max(int(cfg.nPredictParticles), 1) != 1:
        raise ValueError("island mode requires n_predict_particles == 1")


def init_islands(cfg, n_islands: int, device=None, dtype=torch.float32):
    """(state, island_logw): the state at the global P with every local
    log-weight -log P, as JAX's ``init`` starts it (the first step's local
    normalisers then carry -log n each), and uniform island log-weights
    -log n."""
    check_islands(cfg, n_islands)
    state = SlamState.create(cfg, device, dtype)
    island_logw = torch.full((n_islands,), -math.log(float(n_islands)),
                             dtype=dtype, device=device)
    return state, island_logw


def draw_island_noise(cfg, n_islands: int, device, generator=None,
                      dtype=torch.float32):
    """One island step's draws from one generator: (pose_normals [sub, P,
    d], resample_uniforms [P], butterfly_uniforms [rounds, P])."""
    sub = max(int(cfg.subdividePredict), 1)
    P = cfg.n_particles
    normals = torch.randn((sub, P, noise_dim(cfg)), generator=generator,
                          device=device, dtype=dtype)
    uniforms = torch.rand((P,), generator=generator, device=device,
                          dtype=dtype)
    bfly = torch.rand((len(butterfly_strides(n_islands)), P),
                      generator=generator, device=device, dtype=dtype)
    return normals, uniforms, bfly


def _per_island(z: Measurements, n: int) -> Measurements:
    """One measurement set as n identical per-run sets."""
    rep = lambda t: t.expand(n, *t.shape).contiguous()
    return Measurements(rb=rep(z.rb), label=rep(z.label),
                        valid=rep(z.valid), count=(z.count,) * n)


def butterfly_round(log_weights, island_logw, u, stride: int,
                    n_islands: int):
    """One butterfly round at a stride: island k pools its particles with
    island k ^ stride's (its own first) and resamples P/n of them, drawing
    slot j at (j + u_j) / (P/n). Returns (rows [P]: the row of the input
    each output slot takes, the merged island log-weights [n]: the pair's
    mean, total mass kept).

    The pool is weighted by island log-weight + local log-weight, so its
    mass is exp(ilw_k) + exp(ilw_partner), about 2/n, not 1; the
    resample walks that raw cumulative sum, and every slot past the
    pool's mass falls to the overrun guard, the pool's maximum-weight
    particle. At n = 8 equal island weights, 6 of each island's 8 slots
    take one particle. This is the reference's behaviour, copied as it is
    (ROADMAP Queue 3, conditions on the reference side), and
    ``tests/test_torch_island.py`` pins it against JAX's indices."""
    n = n_islands
    p = log_weights.shape[0] // n
    k = torch.arange(n, device=log_weights.device)
    partner = k ^ stride
    lw = log_weights.reshape(n, p)
    idx = _pool_picks(lw, lw[partner], island_logw, island_logw[partner],
                      u, n)
    rows = torch.where(idx < p, k[:, None] * p + idx,
                       partner[:, None] * p + idx - p)
    return rows.reshape(-1), _merged(island_logw, stride)


def _pool_picks(lw, lw_partner, ilw, ilw_partner, u, n_islands: int):
    """The butterfly's picks for q islands (lw, lw_partner [q, p]: each
    island's local log-weights and its partner's; ilw, ilw_partner [q];
    u [q p]): [q, p] int64, slot j of island i taking pool position idx,
    below p its own particle idx, else its partner's idx - p. The resample
    is taken as among all n_islands (``layout_runs``)."""
    q, p = lw.shape
    pool_lw = torch.cat([lw + ilw[:, None], lw_partner + ilw_partner[:, None]],
                        1)
    idx = stratified_resample_indices(pool_lw.reshape(-1), u, p, n_runs=q,
                                      layout_runs=n_islands)
    off = 2 * p * torch.arange(q, device=lw.device)
    return idx.reshape(q, p).long() - off[:, None]


def _merged(island_logw, stride: int):
    """The island log-weights after a round: each pair's mean."""
    partner = torch.arange(island_logw.shape[0],
                           device=island_logw.device) ^ stride
    return torch.logaddexp(island_logw, island_logw[partner]) \
        - math.log(2.0)


def butterfly_exchange(state: SlamState, island_logw, u, trigger,
                       n_islands: int):
    """The butterfly exchange where ``trigger`` (a 0-d bool on the
    device), the inputs unchanged elsewhere; returns (state, island_logw).
    Every round runs (strides 1, 2, 4, ..., round r on the uniforms
    u[r]), the rounds' row maps compose, and the state is gathered once:
    afterwards the local log-weights are -log(P/n), each island's lineage
    0 .. P/n - 1 and the island weights the pairs' means."""
    n = n_islands
    P = state.n_particles
    p = P // n
    dev, dtype = state.device, state.log_weights.dtype
    arange = torch.arange(P, device=dev)
    uniform_lw = torch.full((P,), -math.log(float(p)), dtype=dtype,
                            device=dev)
    rows, lw, ilw = arange, state.log_weights, island_logw
    for r, stride in enumerate(butterfly_strides(n)):
        pick, ilw = butterfly_round(lw, ilw, u[r], stride, n)
        rows = rows[pick]
        lw = uniform_lw      # every later round pools uniform local weights
    rows = torch.where(trigger, rows, arange)
    lineage = torch.arange(p, dtype=torch.int32, device=dev).repeat(n)
    new = state.map(lambda t: t.index_select(0, rows))
    new = new.replace(
        log_weights=torch.where(trigger, uniform_lw, state.log_weights),
        resample_idx=torch.where(trigger, lineage, state.resample_idx))
    return new, torch.where(trigger, ilw, island_logw)


def butterfly_ranks(state: SlamState, island_logw, u, n_islands: int,
                    mesh):
    """The butterfly exchange across the mesh's ranks, run (the caller has
    read its trigger): ``butterfly_exchange``'s result on the rank's q =
    n/W islands, bit for bit. Rounds at strides below q compose a map of
    the rank's rows; at a stride s >= q the rank swaps its current shard
    (every leaf packed into one int32 tensor) with rank r ^ (s / q) and
    picks from [own, partner's], island i's partner at local position i
    there. Returns (state, island_logw); the island weights are global."""
    n = n_islands
    q = n // mesh.world_size
    p = state.n_particles // q
    dev, dtype = state.device, state.log_weights.dtype
    i = torch.arange(q, device=dev)
    k = mesh.rank * q + i                     # the rank's islands
    uniform_lw = torch.full((q * p,), -math.log(float(p)), dtype=dtype,
                            device=dev)
    packed, unpack = pack_rows(state)
    rows = torch.arange(q * p, device=dev)    # each slot's row of packed
    lw, ilw = state.log_weights, island_logw
    for r, stride in enumerate(butterfly_strides(n)):
        u_own = mesh.local(u[r])
        if stride < q:
            mate = i ^ stride
            lw_mate, at = lw.reshape(q, p)[mate], mate
        else:
            own = packed.index_select(0, rows)
            theirs = exchange_rows(own, mesh.rank ^ (stride // q), mesh,
                                   "butterfly")
            if r == 0:    # round 0 pools the partner's own local weights
                lw_mate = unpack(theirs).log_weights.reshape(q, p)
            else:
                lw_mate = uniform_lw.reshape(q, p)
            packed = torch.cat([own, theirs])
            rows, at = torch.arange(2 * q * p, device=dev), i + q
        idx = _pool_picks(lw.reshape(q, p), lw_mate, ilw[k],
                          ilw[k ^ stride], u_own, n)
        pick = torch.where(idx < p, i[:, None] * p + idx,
                           at[:, None] * p + idx - p)
        rows = rows[pick.reshape(-1)]
        ilw = _merged(ilw, stride)
        lw = uniform_lw
    new = unpack(packed.index_select(0, rows))
    lineage = torch.arange(p, dtype=torch.int32, device=dev).repeat(q)
    return new.replace(log_weights=uniform_lw, resample_idx=lineage), ilw


def island_slam_step(state: SlamState, island_logw, control,
                     z: Measurements, dt: float, do_predict: bool, cfg,
                     n_islands: int, *, thresh: float = 0.5, generator=None,
                     noise=None, z_prev: Measurements = None,
                     with_log_state: bool = False, mesh=None):
    """One island-model SLAM step; returns (state', island_logw',
    IslandAux), and an IslandLogAux last with ``with_log_state``.

    state        P = cfg.n_particles rows, island k in block k; with a
                 mesh the rank's P/W rows (its n/W islands)
    island_logw  [n] normalised island log-weights (all n on every rank)
    control, z, dt, do_predict: as ``slam_step``'s (one shared set)
    thresh       the exchange runs when the island nEff is at or below it
    noise        ``draw_island_noise``'s triple, to replay given draws;
                 otherwise drawn from ``generator``
    z_prev       the previous step's measurements (None: an empty set, as
                 JAX's island step passes)
    mesh         a ``parallel.mesh.ParticleMesh`` whose ranks divide n;
                 noise (given or drawn) is the global step's and the aux
                 values are global
    """
    check_islands(cfg, n_islands, mesh)
    n = n_islands
    P = cfg.n_particles
    p = P // n
    every, own = everywhere(mesh, "island")
    n_own = n if mesh is None else n // mesh.world_size
    dev, dtype = state.device, state.log_weights.dtype
    if noise is None:
        noise = draw_island_noise(cfg, n, dev, generator, dtype)
    normals, uniforms, bfly_u = noise
    if mesh is not None:
        normals, uniforms = mesh.local(normals, 1), own(uniforms)
    if z_prev is None:
        z_prev = Measurements.empty(z.rb.shape[-2], dev)
    state, aux = slam_step(state, control, _per_island(z, n_own), dt,
                           do_predict, cfg.replace(n_particles=p),
                           noise=(normals, uniforms),
                           z_prev=_per_island(z_prev, n_own), layout_runs=n)

    # the local normaliser is the island's likelihood increment; normalise
    # across islands as JAX does (max, then the log of the shifted sum)
    ilw = island_logw + every(aux.log_lik)
    lse = ilw.max()
    shift = ilw - lse
    norm = torch.log(torch.exp(shift).sum())
    ilw = shift - norm
    log_lik = lse + norm
    island_neff = 1.0 / (torch.exp(2.0 * ilw).sum() * n)
    exp_pose = (torch.exp(ilw)[:, None] * every(aux.expected_pose)).sum(0)

    exchanged = island_neff <= thresh
    if mesh is None:
        state, ilw = butterfly_exchange(state, ilw, bfly_u, exchanged, n)
    elif read_flag(exchanged, mesh, "butterfly"):
        state, ilw = butterfly_ranks(state, ilw, bfly_u, n, mesh)

    out = (state, ilw, IslandAux(expected_pose=exp_pose, island_logw=ilw,
                                 island_neff=island_neff,
                                 exchanged=exchanged, log_lik=log_lik))
    if with_log_state:
        out = out + (island_log_aux(state, ilw, n, mesh),)
    return out


def island_log_aux(state: SlamState, island_logw, n_islands: int,
                   mesh=None):
    """Each island's local MAP particle's static map and score, and every
    particle's global log-weight; with a mesh each rank's islands', then
    gathered (every field leads with the island or particle axis)."""
    every, own = everywhere(mesh, "island log")
    island_logw = own(island_logw)
    n = n_islands if mesh is None else n_islands // mesh.world_size
    p = state.n_particles // n
    lw = state.log_weights
    best = torch.argmax(lw.reshape(n, p), 1) \
        + torch.arange(n, device=lw.device) * p
    row = lambda t: every(t.index_select(0, best))
    ms = state.map_static
    return IslandLogAux(
        best_score=every(island_logw + lw.index_select(0, best)),
        best_w=row(ms.w), best_mx=row(ms.mx), best_my=row(ms.my),
        best_c00=row(ms.c00), best_c01=row(ms.c01), best_c11=row(ms.c11),
        log_weights=every(torch.repeat_interleave(island_logw, p) + lw),
        poses=every(state.pose), resample_idx=every(state.resample_idx))


def island_run_scan(state: SlamState, island_logw, controls, zs, dts, cfg,
                    n_islands: int, *, thresh: float = 0.5, generator=None,
                    noises=None, with_log_state: bool = False, mesh=None):
    """``island_slam_step`` over a whole dataset without reading the device
    (``filter/step.py::run_scan``'s island counterpart): controls [T, 2]
    and dts [T] on the host, zs T Measurements on the state's device; step
    0 skips prediction and has an empty previous set, every later step
    gets its predecessor's. Returns (state', island_logw', stacked
    IslandAux), and a stacked IslandLogAux last with ``with_log_state``;
    with a mesh the state holds the rank's islands and the stacked values
    are global."""
    dev = state.device
    z_prev = Measurements.empty(zs[0].rb.shape[-2], dev)
    auxs, logs = [], []
    for t, z in enumerate(zs):
        out = island_slam_step(
            state, island_logw, (float(controls[t][0]),
                                 float(controls[t][1])),
            z, float(dts[t]), t > 0, cfg, n_islands, thresh=thresh,
            generator=generator, noise=None if noises is None else noises[t],
            z_prev=z_prev, with_log_state=with_log_state, mesh=mesh)
        state, island_logw = out[0], out[1]
        auxs.append(out[2])
        if with_log_state:
            logs.append(out[3])
        z_prev = z
    stacked = IslandAux(*(torch.stack(f) for f in zip(*auxs)))
    if with_log_state:
        return state, island_logw, stacked, IslandLogAux(
            *(torch.stack(f) for f in zip(*logs)))
    return state, island_logw, stacked
