"""The Monte-Carlo run axis: R independent runs of one configuration in one
state, blockwise on the particle axis (run r holds rows [r P, (r + 1) P),
P = ``cfg.n_particles``), the layout of ``phdslam_tpu/eval/batch.py``'s
vmapped path.

A step's measurements are then per run: ``rb [R, M, 2]``, ``label`` and
``valid [R, M]``. A 2-D ``rb`` is one set shared by every particle, the
single run of every other caller. The helpers here meet per-run tensors
with per-particle ones (``rows``) and reduce over each run's particles
(``run_view``, ``normalise``); with one shared set they compute what the
single-run code always computed.
"""

from __future__ import annotations

import dataclasses

import torch

from phdslam_tpu_torch.ops.resample import among


def rows(x, n_particles: int, shared_dim: int):
    """A measurement tensor broadcast against [n_particles, ...] tensors:
    a shared one (``x.dim() == shared_dim``) as [1, ...]; a per-run one
    [R, ...] as one row per particle, [n_particles, ...] (each run's row
    repeated for its particles), or as is when R = 1."""
    if x.dim() == shared_dim:
        return x[None]
    if x.shape[0] == 1:
        return x
    return torch.repeat_interleave(x, n_particles // x.shape[0], dim=0)


def run_view(x, n_runs):
    """[R P, ...] as [R, P, ...]; unchanged when n_runs is None."""
    return x if n_runs is None else x.reshape(n_runs, -1, *x.shape[1:])


def per_particle(x, n_particles: int):
    """A per-run tensor [R, ...] repeated for each run's particles:
    [n_particles, ...]."""
    return torch.repeat_interleave(x, n_particles // x.shape[0], dim=0)


def normalise(lw, n_runs, layout_runs=None):
    """(lw - its logsumexp, the logsumexp), over each run's particles:
    the logsumexp is a scalar for one run (n_runs None), [R] for R, taken
    as among ``layout_runs`` runs (``ops/resample.py``)."""
    if n_runs is None:
        log_lik = torch.logsumexp(lw, 0)
        return lw - log_lik, log_lik
    v = lw.reshape(n_runs, -1)
    log_lik = among(lambda x: torch.logsumexp(x, 1), v, layout_runs)
    return (v - log_lik[:, None]).reshape(-1), log_lik


def select_runs(keep, new, old):
    """Per-run choice between two states (or mixtures) of one layout:
    run r's rows from ``new`` where ``keep[r]``, else from ``old``. keep:
    bool [R] on the device; a None field stays None."""

    def pick(a, b):
        m = per_particle(keep, a.shape[0])
        return torch.where(m.reshape(-1, *([1] * (a.dim() - 1))), a, b)

    out = {}
    for f in dataclasses.fields(new):
        a, b = getattr(new, f.name), getattr(old, f.name)
        if dataclasses.is_dataclass(a):
            out[f.name] = select_runs(keep, a, b)
        elif isinstance(a, torch.Tensor):
            out[f.name] = pick(a, b)
        else:
            out[f.name] = a
    return dataclasses.replace(new, **out)
