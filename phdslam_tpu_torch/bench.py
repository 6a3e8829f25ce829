"""The port's dense-stress benchmark: ms per GM-PHD SLAM step on one CUDA GPU.

    python3 -m phdslam_tpu_torch.bench [--quick]

The method and contract of the JAX package's ``bench.py``: the shipped
``cfg/ackerman_synth.cfg`` at the dense-stress shape (8192 particles x 512
map slots x 64 measurements, clutter 50; ``--quick``: 512 x 128) on the
clutter-heavy stress stream; 3 warm-up steps, a warmed snapshot, then 5
windows that each replay steps 3-18 from it, interleaved over three
configurations (exact merge, ``merge_mode`` 1, ``merge_mode`` 1 with
``select_top_k`` 2); each configuration's fastest window. ``vs_baseline``
divides the NumPy CPU reference's ms per step, extrapolated linearly to
the particle count, by the exact mode's: the pinned anchor
``results/dense_cpu_anchor.json`` where its key matches, else a run of
``reference_cpu.run`` at 32 particles (written nowhere).

Prints ONE JSON line:
  {"metric": "ms_per_slam_step_8192p_cuda", "value": <ms>, "unit": "ms",
   "vs_baseline": ..., "particle_updates_per_sec": ..., "ms_fast_merge":
   ..., "ms_fast_k2": ..., "cpu_reference_ms_extrapolated": ...,
   "device": <torch.cuda.get_device_name(0)>, "power_limit_w": ...,
   "cpu_anchor": "pinned" | "measured"}

Without a CUDA device it exits non-zero and prints the reason; it never
falls back to the CPU. The functions below ``main`` take a device, so the
tests drive them on the CPU at tiny shapes.
"""

from __future__ import annotations

import hashlib
import json
import math
import subprocess
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
ANCHOR = ROOT / "results" / "dense_cpu_anchor.json"

#: the only fields dense_stress_config may override relative to the
#: shipped cfg: shape and scene density, never filter semantics
STRESS_OVERRIDES = ("n_particles", "maxFeatures", "maxMeasurements",
                    "y0", "birthWeight", "clutterRate",
                    "clutterDensity")   # derived from clutterRate

#: the fields the CPU reference reads: the anchor's key hashes these only,
#: so an unrelated config field does not invalidate it
CPU_FIELDS = (
    "a", "ax", "ay", "ayaw", "b", "beta", "birthNoiseFactor",
    "birthWeight", "birthWeightDynamic", "clutterDensity",
    "clutterRate", "cnPoissonPredict", "covVxBirth", "covVyBirth",
    "dt", "featureModel", "filterType", "gateBirths", "gateThreshold",
    "h", "l", "labeledMeasurements", "maxBearing", "maxCardinality",
    "maxRange", "minFeatureWeight", "minRange", "minSeparation",
    "motionType", "n_particles", "particleWeighting", "pd", "ps",
    "resampleThresh", "stdAlpha", "stdAxMap", "stdAyMap", "stdBearing",
    "stdEncoder", "stdRange", "subdividePredict", "tau", "vx0", "vy0",
    "vyaw0", "x0", "y0", "yaw0", "maxFeatures", "maxMeasurements")

#: the timed configurations: (name, overrides of the stress config); the
#: first, the shipped exact merge, is the headline
MODES = (("exact", {}), ("fast merge", dict(mergeMode=1)),
         ("fast merge, k2", dict(mergeMode=1, selectTopK=2)))
#: steps of the stress stream, warm-up steps before the snapshot, and
#: windows per mode (each replays steps WARMUP .. N_STEPS - 1)
N_STEPS, WARMUP, WINDOWS = 19, 3, 5


def make_stress_inputs(cfg, n_steps, seed=0):
    """Clutter-heavy measurement stream + wandering controls: 90 % of the
    slots hold uniform clutter every step. (rb [T, M, 2], valid [T, M],
    controls [T, 2]), numpy."""
    rng = np.random.default_rng(seed)
    m = cfg.maxMeasurements
    rb = np.zeros((n_steps, m, 2), np.float32)
    valid = np.zeros((n_steps, m), bool)
    k = int(m * 0.9)
    rb[:, :k, 0] = rng.uniform(0.5, cfg.maxRange, (n_steps, k))
    rb[:, :k, 1] = rng.uniform(-cfg.maxBearing, cfg.maxBearing, (n_steps, k))
    valid[:, :k] = True
    controls = np.zeros((n_steps, 2), np.float32)
    controls[:, 0] = 1.5
    controls[:, 1] = 0.1 * np.sin(np.arange(n_steps) / 10.0)
    return rb, valid, controls


def dense_overrides(cfg):
    """The scene of the dense-stress config (the shape apart): the robot
    on the x axis, a low birth weight, clutter 50."""
    return cfg.replace(y0=0.0, birthWeight=1e-3, clutterRate=50.0)


def dense_stress_config():
    """The headline config: the SHIPPED cfg/ackerman_synth.cfg at the
    dense-stress shape. Only shape and scene fields are overridden
    (STRESS_OVERRIDES); merge and selection semantics are the shipped
    cfg's."""
    from phdslam_tpu_torch.config import load_config
    return dense_overrides(load_config(str(ROOT / "cfg/ackerman_synth.cfg"))
                           .replace(n_particles=8192, maxFeatures=512,
                                    maxMeasurements=64))


def synchronize(device):
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StressRunner:
    """bench.py's timed runner on ``device``: ``warmup`` steps of
    ``slam_step`` on the stress stream, then a snapshot of the warmed state
    and generator; every ``window()`` restores the snapshot, replays steps
    ``warmup`` .. ``n_steps`` - 1 and returns ms per step (host clock, the
    window ending in a device synchronise). ``slam_step`` makes a new
    state, so the snapshot is the warmed state's reference."""

    def __init__(self, cfg, device, n_steps=N_STEPS, warmup=WARMUP):
        import torch

        from phdslam_tpu_torch.filter.state import Measurements, SlamState
        self.cfg, self.device = cfg, torch.device(device)
        self.n_steps, self.warmup = n_steps, warmup
        rb, valid, self.controls = make_stress_inputs(cfg, n_steps)
        labels = np.zeros((cfg.maxMeasurements,), np.int32)
        self.zs = [Measurements.from_numpy(rb[t], labels, valid[t],
                                           self.device)
                   for t in range(n_steps)]
        self.gen = torch.Generator(device=self.device).manual_seed(0)
        state = SlamState.create(cfg, self.device)
        for t in range(warmup):
            state, _ = self.step(state, t)
        synchronize(self.device)
        self.warm = (state, self.gen.get_state())
        self.state = self.aux = None

    def step(self, state, t):
        from phdslam_tpu_torch.filter.step import slam_step
        return slam_step(state, (float(self.controls[t, 0]),
                                 float(self.controls[t, 1])), self.zs[t],
                         float(self.cfg.dt), t > 0, self.cfg,
                         generator=self.gen)

    def window(self):
        state, gen_state = self.warm
        self.gen.set_state(gen_state)
        t0 = time.perf_counter()
        for t in range(self.warmup, self.n_steps):
            state, aux = self.step(state, t)
        synchronize(self.device)
        ms = (time.perf_counter() - t0) / (self.n_steps - self.warmup) * 1e3
        self.state, self.aux = state, aux
        neff = float(aux.neff)
        if not math.isfinite(neff):
            raise RuntimeError(f"neff {neff} in the benchmark run")
        return ms


def bench_many(cfgs, device, n_steps=N_STEPS, warmup=WARMUP,
               n_windows=WINDOWS):
    """ms/step per config: the minimum over n_windows windows, the
    configs' windows interleaved so that each config samples the same
    drift of the host and the card (bench.py's rationale: delays are
    additive, so the fastest window is the least disturbed)."""
    runners = [StressRunner(cfg, device, n_steps, warmup) for cfg in cfgs]
    reps = [[] for _ in cfgs]
    for _ in range(n_windows):
        for i, runner in enumerate(runners):
            reps[i].append(runner.window())
    return [min(r) for r in reps]


def anchor_key(cfg_small, n_steps):
    """The pinned anchor's key: bench.py's hash of CPU_FIELDS, the step
    count and the stress stream's version."""
    return hashlib.sha256(
        repr(([(f, getattr(cfg_small, f, None)) for f in CPU_FIELDS],
              n_steps, "make_stress_inputs-v1-seed0")).encode()
    ).hexdigest()[:16]


def bench_cpu_reference(cfg, n_particles=32, n_steps=4, anchor_path=ANCHOR):
    """The NumPy CPU reference's ms per step at n_particles (it scales
    linearly in particles: each is independent). Returns (ms, n_particles,
    "pinned") from the anchor file where its key matches, else (ms,
    n_particles, "measured") from a run of reference_cpu.run over one
    warm-in step and n_steps more; the run is written nowhere."""
    cfg_small = cfg.replace(n_particles=n_particles)
    key = anchor_key(cfg_small, n_steps)
    path = Path(anchor_path)
    if path.exists():
        anchor = json.loads(path.read_text())
        if anchor.get("key") == key:
            return (float(anchor["ms_per_step"]), int(anchor["n_particles"]),
                    "pinned")
    from phdslam_tpu_torch import reference_cpu as R

    rb, valid, controls = make_stress_inputs(cfg_small, n_steps + 1)
    meas = [rb[t][valid[t]] for t in range(n_steps + 1)]
    t0 = time.perf_counter()
    R.run(cfg_small, controls[1:], meas, seed=0)
    ms = (time.perf_counter() - t0) / (n_steps + 1) * 1e3
    return ms, n_particles, "measured"


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


def main(argv=None):
    """Time the three modes on cuda:0, print the JSON line and return it
    as a dict; without a CUDA device, exit non-zero."""
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="512 particles x 128 map slots")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (torch.cuda.is_available() "
                         "is False); the benchmark runs only on a GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gpu = gpu_line()

    stress = dense_stress_config()
    if args.quick:
        stress = stress.replace(n_particles=512, maxFeatures=128)
    ms_exact, ms_fast, ms_fast_k2 = bench_many(
        [stress.replace(**over) for _, over in MODES], dev)
    cpu_ms, cpu_p, anchor = bench_cpu_reference(stress)
    cpu_ms_extrap = cpu_ms * (stress.n_particles / cpu_p)
    record = {
        "metric": f"ms_per_slam_step_{stress.n_particles}p_cuda",
        "value": round(ms_exact, 3),
        "unit": "ms",
        "vs_baseline": round(cpu_ms_extrap / ms_exact, 2),
        "particle_updates_per_sec": round(
            stress.n_particles / (ms_exact / 1000.0)),
        "ms_fast_merge": round(ms_fast, 3),
        "ms_fast_k2": round(ms_fast_k2, 3),
        "cpu_reference_ms_extrapolated": round(cpu_ms_extrap, 1),
        "device": torch.cuda.get_device_name(0),
        "power_limit_w": power_limit_w(gpu),
        "cpu_anchor": anchor,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
