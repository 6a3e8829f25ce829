"""Faults planted under the timed path, for test_harness_check.py. Each is
a function a run's process calls before it builds the program (spawned
ranks import it by name), patching the port in that process only."""

from __future__ import annotations


def _wrap_step(after):
    from phdslam_tpu_torch.filter import step as S
    orig = S.slam_step

    def slam_step(state, *a, **kw):
        new, aux = orig(state, *a, **kw)
        return after(state, new, aux)

    S.slam_step = slam_step


def unchanged():
    """A step that returns its state unchanged."""
    _wrap_step(lambda old, new, aux: (old, aux))


def half_batch():
    """Half of the particles left out of the normalisation: the
    logsumexp taken over the first half only."""
    import torch

    from phdslam_tpu_torch.filter import step as S

    def normalise(lw, n_runs, layout_runs=None):
        log_lik = torch.logsumexp(lw[: lw.shape[0] // 2], 0)
        return lw - log_lik, log_lik

    S.normalise = normalise


def no_exchange():
    """The exchange between ranks left out: each rank's rows stand in for
    every rank's."""
    from phdslam_tpu_torch.parallel import mesh as Mh

    def gather_rows(x, mesh, label="rows"):
        return x.repeat(mesh.world_size, *([1] * (x.dim() - 1)))

    Mh.gather_rows = gather_rows


def altered_answer():
    """The expected pose altered where it is produced (1 cm in x)."""
    def after(old, new, aux):
        pose = aux.expected_pose.clone()
        pose[0] += 0.01
        return new, aux._replace(expected_pose=pose)

    _wrap_step(after)
