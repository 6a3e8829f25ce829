"""Visualisation: log player frames and batch error curves, the port's host
copy of ``phdslam_tpu/eval/plots.py``.

Headless matplotlib renderers of the reference's visual checks
(python/plot_phdslam.py, matlab/plotPhdSlam.m, python/plot_results.py):
per-step frames (truth map and trajectory, estimated trajectory, 3-sigma
feature ellipses above the weight threshold, particle cloud) and the
mean +- std error curves of a batch. matplotlib is imported inside the
functions that draw: a machine without it (the GPU machine has none) can
import this module and run everything else.
"""

from __future__ import annotations

import os

import numpy as np


def _ellipse_points(mean, cov, n_sigma=3.0, n_pts=24):
    """3-sigma ellipse polyline (matlab/makeCovEllipses.m)."""
    vals, vecs = np.linalg.eigh(cov)
    vals = np.maximum(vals, 1e-12)
    t = np.linspace(0, 2 * np.pi, n_pts)
    circle = np.stack([np.cos(t), np.sin(t)])
    pts = vecs @ (np.sqrt(vals)[:, None] * circle) * n_sigma
    return pts[0] + mean[0], pts[1] + mean[1]


def render_step(ax, log_record, true_map=None, true_traj=None, t=None,
                est_traj=None, min_weight=0.33):
    """Draw one step onto a matplotlib axes from a parsed state_estimate
    record (plot_phdslam.py:219-228 semantics: ellipses for features with
    w >= 0.33, particle cloud, estimated + true trajectories)."""
    if true_map is not None and len(true_map):
        ax.plot(true_map[:, 0], true_map[:, 1], "k*", ms=8, label="truth")
    if true_traj is not None and t is not None:
        ax.plot(true_traj[0, : t + 1], true_traj[1, : t + 1], "k-",
                lw=1, alpha=0.6)
    poses = log_record["poses"]
    ax.plot(poses[:, 0], poses[:, 1], ".", color="tab:gray", ms=2,
            alpha=0.4, label="particles")
    if est_traj is not None:
        ax.plot(est_traj[:, 0], est_traj[:, 1], "b-", lw=1.2,
                label="estimate")
    pose = log_record["pose"]
    ax.plot(pose[0], pose[1], "bo", ms=6)
    static = log_record["static"]
    for row in static:
        w, mx, my = row[0], row[1], row[2]
        if w < min_weight:
            continue
        cov = row[3:7].reshape(2, 2)
        ex, ey = _ellipse_points(np.array([mx, my]), cov)
        ax.plot(ex, ey, "r-", lw=0.8)
        ax.plot(mx, my, "r+", ms=5)
    ax.set_aspect("equal")


def render_log_dir(log_dir: str, out_path: str, true_map=None,
                   true_traj=None, every: int = 10, fmt: str = "png",
                   min_weight: float = 0.33):
    """Render a directory of state_estimate logs into PNG frames (or one
    GIF when out_path ends with .gif)."""
    import glob

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from phdslam_tpu_torch.io.logs import read_state_estimate_log

    files = sorted(glob.glob(os.path.join(log_dir, "state_estimate*.log")))
    records = [read_state_estimate_log(f) for f in files]
    est_traj = np.stack([r["pose"][:2] for r in records])
    frames = []
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    for t in range(0, len(records), every):
        fig, ax = plt.subplots(figsize=(7, 7))
        render_step(ax, records[t], true_map=true_map, true_traj=true_traj,
                    t=t, est_traj=est_traj[: t + 1], min_weight=min_weight)
        ax.set_title(f"step {t}")
        if out_path.endswith(".gif"):
            fig.canvas.draw()
            frames.append(np.asarray(fig.canvas.buffer_rgba()).copy())
            plt.close(fig)
        else:
            fig.savefig(out_path.replace(f".{fmt}", f"_{t:05d}.{fmt}"),
                        dpi=90)
            plt.close(fig)
    if frames and out_path.endswith(".gif"):
        try:
            from PIL import Image
            imgs = [Image.fromarray(fr) for fr in frames]
            imgs[0].save(out_path, save_all=True, append_images=imgs[1:],
                         duration=200, loop=0)
        except ImportError:
            # fall back to per-frame PNGs next to the requested gif
            for i, fr in enumerate(frames):
                import matplotlib.pyplot as plt
                plt.imsave(out_path.replace(".gif", f"_{i:04d}.png"), fr)
    return len(records)


def plot_error_curves(aggregates, out_path: str, labels=None):
    """Mean±std error envelopes over time for one or more batches
    (python/plot_results.py:21-66): pose error, plus OSPA / localization /
    cardinality curves when the batch scored maps."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(aggregates, dict):
        aggregates = [aggregates]
    labels = labels or [f"batch {i}" for i in range(len(aggregates))]
    panels = [("pose_err", "pose error [m]")]
    if any("ospa_mean" in a for a in aggregates):
        panels += [("ospa", "OSPA(p=1,c=5)"), ("loc", "localization err"),
                   ("card", "OSPA cardinality comp.")]
    if any("card_err_mean" in a for a in aggregates):
        # |E[n] - n_visited|: the filter's map-cardinality error vs the
        # cumulative visited-landmark truth (reference logs the pmf for
        # exactly this offline scoring, src/main.cpp:937-952)
        panels += [("card_err", "|card est - visited|")]
    fig, axes = plt.subplots(len(panels), 1,
                             figsize=(8, 3.2 * len(panels)), squeeze=False)
    for ax, (key, ylab) in zip(axes[:, 0], panels):
        for agg, lab in zip(aggregates, labels):
            if f"{key}_mean" not in agg:
                continue
            m = agg[f"{key}_mean"]
            s = agg[f"{key}_std"]
            t = np.arange(len(m))
            ok = np.isfinite(m)
            ax.plot(t[ok], m[ok], label=lab)
            ax.fill_between(t[ok], (m - s)[ok], (m + s)[ok], alpha=0.25)
        ax.set_ylabel(ylab)
        ax.legend()
    axes[-1, 0].set_xlabel("time step")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
