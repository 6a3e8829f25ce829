"""What the evidence entry points share: their flags, the device and the
card's ``nvidia-smi`` line, the results file, the Monte-Carlo scenario and
config of ``scripts/round3_evidence.py`` and the late-half statistics.

An entry point with a NumPy CPU reference leg runs it in this process
after its GPU legs, as the JAX scripts do, so that no timed leg shares the
host with another.

The results go to ``results/port_evidence.json`` (``--out``), merged under
the JAX scripts' own keys; the JAX package's records stay as they are and
are the bars. Every entry gains ``device`` and ``power_limit_w`` (from
``nvidia-smi``; ``"cpu"`` and null on the CPU)."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
RESULTS = "results/port_evidence.json"
CONTROL_NOISE = (0.2, 0.01)
#: --smoke: the tiny widths of a code-path check on the CPU
SMOKE_WIDTHS = dict(n_particles=16, maxFeatures=16, maxMeasurements=16)


def parser(description: str, plot: bool = False) -> argparse.ArgumentParser:
    """The flags every entry point takes (and --plot where it draws)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--quick", action="store_true",
                    help="the JAX script's --quick sizes (a script without "
                    "them runs in full)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes, nothing written: a code-path check")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--out", default=RESULTS,
                    help=f"the results file (default {RESULTS})")
    if plot:
        ap.add_argument("--plot", action="store_true",
                        help="draw the envelopes (needs matplotlib)")
    return ap


def add_cpu_leg_flags(ap: argparse.ArgumentParser):
    """The flag of an entry point with a NumPy CPU reference leg."""
    ap.add_argument("--cpu-steps", type=int, default=0,
                    help="cut each CPU reference leg to its first N steps "
                    "(0: the script's own); the cut is written down")


def resolve_device(name: str):
    """The torch device; CUDA raises without a GPU (no CPU fallback)."""
    import torch
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: CUDA is not available; "
                               "pass --device cpu to run on the CPU")
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    return dev


def gpu_line():
    """nvidia-smi's "name, power.limit" of the first card, as it prints
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


def power_limit_w(line):
    """The watts of gpu_line()'s power limit ("..., 700.00 W")."""
    return float(line.rsplit(",", 1)[1].split()[0])


def device_fields(dev) -> dict:
    """``device`` and ``power_limit_w`` of an entry: nvidia-smi's name and
    power limit of the card, or "cpu" and None."""
    if dev.type != "cuda":
        return dict(device="cpu", power_limit_w=None)
    line = gpu_line()
    return dict(device=line.rsplit(",", 1)[0].strip(),
                power_limit_w=power_limit_w(line))


def read_results(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def merge_json(update: dict, path: str, fields: dict, merge=None):
    """Merge ``update`` (key -> entry) into the results file, each entry
    with the device fields, and print it. ``merge(previous, new)``, when
    given, makes each entry from the one the file held (or {}) and the new
    one. The file is replaced whole, never left half written."""
    update = {k: dict(v, **fields) for k, v in update.items()}
    data = read_results(path)
    if merge is not None:
        update = {k: merge(data.get(k, {}), v) for k, v in update.items()}
    data.update(update)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(data, f, indent=1)
    os.replace(path + ".tmp", path)
    print(json.dumps(update), flush=True)
    return update


def load_cfg(name: str):
    from phdslam_tpu_torch.config import load_config
    return load_config(str(ROOT / name))


def mc_scenario(n_steps: int):
    """round3_evidence.py's Monte-Carlo scenario: 80 landmarks, seed 42."""
    from phdslam_tpu_torch.simdata import make_scenario
    return make_scenario(np.random.default_rng(42), n_landmarks=80,
                         n_steps=n_steps)


def mc_base_cfg(smoke: bool = False):
    """round3_evidence.py's base config: the shipped static cfg at 256
    particles (--smoke: the tiny widths)."""
    cfg = load_cfg("cfg/ackerman_synth.cfg").replace(n_particles=256)
    return cfg.replace(**SMOKE_WIDTHS) if smoke else cfg


def start_pose(cfg, traj):
    """The config started at the trajectory's first pose."""
    return cfg.replace(x0=float(traj[0, 0]), y0=float(traj[0, 1]),
                       yaw0=float(traj[0, 2]))


def late_half(curve, t_len: int):
    """The second half of a per-step curve of t_len steps."""
    return np.asarray(curve)[t_len // 2:]


def late_stats(agg: dict, t_len: int, final: bool = False) -> dict:
    """The late-half envelope of an ``aggregate``: mean OSPA, its spread
    over runs, (the final OSPA,) the mean pose error."""
    out = dict(
        ospa_late_mean=float(np.nanmean(late_half(agg["ospa_mean"], t_len))),
        ospa_late_std=float(np.nanmean(late_half(agg["ospa_std"], t_len))))
    if final:
        out["ospa_final_mean"] = float(agg["ospa_mean"][-1])
    out["pose_late_mean"] = float(
        late_half(agg["pose_err_mean"], t_len).mean())
    return out


def pose_errors(poses, traj, dims: int = 2):
    """Per-step position error of expected poses against the truth."""
    t_len = len(poses)
    return np.linalg.norm(np.asarray(poses)[:, :dims] - traj[:t_len, :dims],
                          axis=1)


def cut(full: int, requested: int) -> int:
    """A CPU leg's length: the script's own, or the cut if smaller."""
    return min(full, requested) if requested > 0 else full


def plot(aggs, name: str, labels, results_path: str):
    """plot_error_curves into results/<name>.png beside the results file."""
    from phdslam_tpu_torch.eval.plots import plot_error_curves
    out = os.path.join(os.path.dirname(results_path) or ".", name + ".png")
    return plot_error_curves(aggs, out, labels=labels)
