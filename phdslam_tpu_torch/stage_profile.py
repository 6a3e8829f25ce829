"""Per-stage times of the port's filter paths on one CUDA GPU.

    python3 -m phdslam_tpu_torch.stage_profile [--quick]

The port of the JAX package's ``scripts/tpu_profile.py``. At the dense
(8192 x 512 x 64) and the typical (256 x 128 x 32) shape (``--quick``:
the typical one alone), on ``cfg/ackerman_synth.cfg`` with clutter 40 and
gated births at 9.0, over a random but realistic problem (``make_problem``:
poses, three quarters of the map slots live, M - 3 valid measurements), it
times:

  kalman_preupdate; phd_update_static (kernel; index sel); slam_step
  static (kernel; index sel; fast merge; fast merge, k2; fast merge, index
  sel); slam_step CPHD (P = min(P, 1024), max_cardinality 63); slam_step
  mixed (feature_model 2, min(F, 256) slots); and once, disparity_step at
  128 particles x 64 slots on 32 fixed measurements.

Each stage: one call, then 3 windows of 5 calls (3 with ``--quick``), each
window ending in a device synchronise; the fastest window's ms per call.
Prints one line per stage, then one JSON line: {"device", "power_limit_w",
"stages": {name: ms}}. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import json
import time

import numpy as np

from phdslam_tpu_torch.bench import ROOT, gpu_line, power_limit_w, synchronize

SHAPES = (("dense", (8192, 512, 64)), ("typical", (256, 128, 32)))
DISPARITY = (128, 64, 32)         # particles, map slots, measurements
WINDOWS = 3


def make_problem(rng, cfg, P, F, M, device):
    """``scripts/tpu_kernel_check.py::make_problem``'s distributions and
    shapes, drawn from a numpy Generator: (pose [P, 6], map, measurements);
    three quarters of the map slots live, the last 3 measurements padding."""
    import torch

    from phdslam_tpu_torch.filter.state import Gaussian2DMixture, Measurements
    pose = np.concatenate([rng.uniform(-2, 2, (P, 2)),
                           rng.uniform(-3, 3, (P, 1)),
                           np.zeros((P, 3))], axis=1)
    n_act = F * 3 // 4
    lim = 0.7 * cfg.maxRange
    mx = rng.uniform(-lim, lim, (P, F))
    my = rng.uniform(-lim, lim, (P, F))
    w = np.where(np.arange(F) < n_act, rng.uniform(0.05, 1.5, (P, F)), 0.0)
    c00 = rng.uniform(0.05, 2.0, (P, F))
    c11 = rng.uniform(0.05, 2.0, (P, F))
    c01 = 0.3 * np.sqrt(c00 * c11) * rng.uniform(-1, 1, (P, F))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    gm = Gaussian2DMixture(w=t(w), mx=t(mx), my=t(my), c00=t(c00),
                           c01=t(c01), c11=t(c11))
    z_rb = np.stack([rng.uniform(0.3, 0.95 * cfg.maxRange, M),
                     rng.uniform(-0.9 * cfg.maxBearing, 0.9 * cfg.maxBearing,
                                 M)], axis=1)
    z = Measurements.from_numpy(z_rb, np.zeros((M,), np.int32),
                                np.arange(M) < M - 3, device)
    return t(pose), gm, z


def timeit(record, name, fn, device, reps, log=print):
    """fn() once, then WINDOWS windows of reps calls, each ending in a
    synchronise; records and logs the fastest window's ms per call."""
    fn()
    synchronize(device)
    best = float("inf")
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        synchronize(device)
        best = min(best, (time.perf_counter() - t0) / reps * 1e3)
    log(f"{name:56s} {best:9.3f} ms")
    record[name] = best
    return best


def profile_stages(device, shapes=SHAPES, disparity=DISPARITY, reps=5,
                   log=print, after=None):
    """Every stage at every (tag, (P, F, M)) of shapes, then the disparity
    step at disparity = (P, F, M); returns {stage name: ms}. after, if
    given, is called with each stage's name once that stage is timed."""
    import torch

    from phdslam_tpu_torch.config import load_config
    from phdslam_tpu_torch.filter import update as U
    from phdslam_tpu_torch.filter.disparity import (DisparityState,
                                                    disparity_step)
    from phdslam_tpu_torch.filter.state import Measurements, SlamState
    from phdslam_tpu_torch.filter.step import slam_step

    device = torch.device(device)
    base = load_config(str(ROOT / "cfg/ackerman_synth.cfg"))
    record = {}

    def time_(name, fn):
        timeit(record, name, fn, device, reps, log)
        if after is not None:
            after(name)

    def stepper(cfg, state, z, **kw):
        gen = torch.Generator(device=device).manual_seed(0)
        return lambda: slam_step(state, (1.0, 0.01), z, 0.5, True, cfg,
                                 generator=gen, **kw)

    for tag, (P, F, M) in shapes:
        cfg = base.replace(n_particles=P, maxFeatures=F, maxMeasurements=M,
                           clutterRate=40.0, gateBirths=True,
                           gateThreshold=9.0)
        pose, gm, z = make_problem(np.random.default_rng(1), cfg, P, F, M,
                                   device)
        log(f"--- {tag}: P={P} F={F} M={M} ---")
        time_(f"{tag}: kalman_preupdate",
              lambda: U.kalman_preupdate(pose, gm, cfg))
        for name, c in (("kernel", cfg),
                        ("kernel, index sel",
                         cfg.replace(selectByIndex=True))):
            time_(f"{tag}: phd_update_static ({name})",
                  lambda c=c: U.phd_update_static(pose, gm, z.rb, z.label,
                                                  z.valid, c))
        state = SlamState.create(cfg, device).replace(pose=pose,
                                                      map_static=gm)
        for name, c in (
                ("kernel", cfg),
                ("kernel, index sel", cfg.replace(selectByIndex=True)),
                ("kernel, fast merge", cfg.replace(mergeMode=1)),
                ("kernel, fast merge, k2",
                 cfg.replace(mergeMode=1, selectTopK=2)),
                ("kernel, fast merge, index sel",
                 cfg.replace(mergeMode=1, selectByIndex=True))):
            time_(f"{tag}: slam_step static ({name})", stepper(c, state, z))

        cfgc = cfg.replace(filterType=1, maxCardinality=63,
                           n_particles=min(P, 1024))
        Pc = cfgc.n_particles
        posec, gmc, _ = make_problem(np.random.default_rng(2), cfgc, Pc, F,
                                     M, device)
        sc = SlamState.create(cfgc, device).replace(pose=posec,
                                                    map_static=gmc)
        time_(f"{tag}: slam_step CPHD (P={Pc})", stepper(cfgc, sc, z,
                                                         z_prev=z))

        cfgm = cfg.replace(featureModel=2, maxFeatures=min(F, 256))
        Pm = cfgm.n_particles
        posem, gmm, _ = make_problem(np.random.default_rng(3), cfgm, Pm,
                                     cfgm.maxFeatures, M, device)
        sm = SlamState.create(cfgm, device).replace(pose=posem,
                                                    map_static=gmm)
        time_(f"{tag}: slam_step mixed (P={Pm})", stepper(cfgm, sm, z))

    Pd, Fd, Md = disparity
    cfgd = base.replace(n_particles=Pd, maxFeatures=Fd, maxMeasurements=Md)
    sd = DisparityState.create(cfgd, device)
    zd = np.stack([np.linspace(100, 500, Md), np.linspace(100, 400, Md)], 1)
    zd = Measurements.from_numpy(zd, np.zeros((Md,), np.int32),
                                 np.ones((Md,), bool), device)
    gen = torch.Generator(device=device).manual_seed(0)
    time_(f"disparity_step (P={Pd}, F={Fd})",
          lambda: disparity_step(sd, zd, 0.1, True, cfgd, generator=gen))
    return record


def main(argv=None):
    """Profile on cuda:0, print a line per stage and the JSON record, and
    return the record; without a CUDA device, exit non-zero."""
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the typical shape only, 3 calls a window")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stage_profile: no CUDA device "
                         "(torch.cuda.is_available() is False); the profile "
                         "runs only on a GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gpu = gpu_line()
    print(gpu, flush=True)
    shapes = SHAPES[1:] if args.quick else SHAPES
    stages = profile_stages(dev, shapes, reps=3 if args.quick else 5,
                            log=lambda s: print(s, flush=True))
    record = {"device": torch.cuda.get_device_name(0),
              "power_limit_w": power_limit_w(gpu), "stages": stages}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
