"""The runner's ``--islands N`` under torchrun, and the mesh's refusals, on
the CPU (gloo, one torch thread a rank).

- ``--islands 4`` on 2 ranks, loop and scan mode: rank 0 writes the
  one-process run's files, each state_estimate log byte for byte.
- A sharded step with a run axis, W not dividing P or n, a default (CUDA)
  mesh on a host without CUDA, and the runner's flags and run types
  without a multi-rank form: each raises by name, and nothing runs in its
  place.

The bit-for-bit cases of the sharded steps are in ``test_torch_mesh.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from phdslam_tpu_torch import runner
from phdslam_tpu_torch.filter.state import Measurements, SlamState
from phdslam_tpu_torch.filter.step import slam_step
from phdslam_tpu_torch.parallel.island import island_slam_step
from phdslam_tpu_torch.parallel.mesh import (ParticleMesh, make_mesh,
                                             shard_state, sharded_step)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN_T = 12
RUN_CFG = """
n_particles = 16
max_features = 16
max_measurements = 8
birth_weight = 0.02
std_encoder = 0.05
std_alpha = 0.005
initial_y = 0.0
n_steps = 12
"""


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    from phdslam_tpu_torch import simdata
    sc = simdata.make_scenario(np.random.default_rng(11), n_landmarks=12,
                               n_steps=RUN_T, clutter_rate=2.0)
    controls, meas = simdata.generate_run(np.random.default_rng(21), sc,
                                          control_noise=(0.05, 0.005))
    d = tmp_path_factory.mktemp("meshrun")
    simdata.write_run_files(str(d), controls, meas[:RUN_T])
    with open(os.path.join(REPO, "cfg/ackerman_synth.cfg")) as f:
        (d / "run.cfg").write_text(f.read() + RUN_CFG)
    return d


def _runner_args(d, out, *extra):
    return [str(d / "run.cfg"), "synth", "--measurements",
            str(d / "measurements.txt"), "--controls",
            str(d / "controls.txt"), "--out-dir", str(out), "--device",
            "cpu", "--seed", "2", "--islands", "4", *extra]


@pytest.mark.parametrize("mode", ["loop", "scan"])
def test_runner_islands_under_torchrun(run_files, tmp_path, mode):
    """--islands 4 under torchrun on 2 gloo ranks: rank 0 writes the one-
    process run's files, every state_estimate log byte for byte and
    metrics.jsonl line for line apart from the times (ms); loopTime.log has
    a line per step."""
    d = run_files
    one, two = tmp_path / "one", tmp_path / "two"
    runner.main(_runner_args(d, one, "--mode", mode))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "phdslam_tpu_torch.runner",
         *_runner_args(d, two, "--mode", mode)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert sorted(os.listdir(one)) == sorted(os.listdir(two))
    logs = sorted(p for p in os.listdir(one)
                  if p.startswith("state_estimate"))
    assert len(logs) == RUN_T
    for name in logs:
        assert (one / name).read_bytes() == (two / name).read_bytes(), name

    def metrics(out):
        rows = [json.loads(line) for line in
                (out / "metrics.jsonl").read_text().splitlines()]
        for r in rows:
            r.pop("ms")
        return rows

    assert metrics(one) == metrics(two)
    assert len((two / "loopTime.log").read_text().split()) == RUN_T


# -------------------------------------------------------------- refusals --

def _fake_mesh(world):
    """A mesh object for checks that refuse before any transfer."""
    return ParticleMesh(rank=0, world_size=world, group=None,
                        backend="gloo", device=torch.device("cpu"))


def test_mesh_refuses_a_run_axis():
    """A sharded step has no run axis (JAX's has none either)."""
    cfg = R.config("static")
    z = Measurements.empty(cfg.maxMeasurements, n_runs=2)
    state = SlamState.create(cfg, n_runs=2)
    with pytest.raises(ValueError, match="no run axis"):
        slam_step(state, (0.0, 0.0), z, 1.0, False, cfg, mesh=_fake_mesh(2))


@pytest.mark.parametrize("what", ["sharded_step", "shard_state",
                                  "islands"])
def test_mesh_refuses_ranks_not_dividing(what):
    """W must divide the particle count and the island count."""
    cfg = R.config("static")
    mesh = _fake_mesh(3)
    with pytest.raises(ValueError, match="not a multiple"):
        if what == "sharded_step":
            sharded_step(cfg, mesh)
        elif what == "shard_state":
            shard_state(SlamState.create(cfg), mesh)
        else:
            cfg = cfg.replace(n_particles=24)
            island_slam_step(SlamState.create(cfg), torch.zeros(4),
                             (0.0, 0.0),
                             Measurements.empty(cfg.maxMeasurements), 1.0,
                             False, cfg, 4, mesh=mesh)


def test_make_mesh_refuses_missing_cuda():
    """No CUDA on this host: the default device (cuda:LOCAL_RANK) raises,
    and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(rank=0, world_size=1, init_method="file:///nonexistent")


REFUSALS = {
    "resume": (lambda a: a + ["--resume"], "--resume"),
    "checkpoint_every": (lambda a: a + ["--checkpoint-every", "5"],
                         "--checkpoint-every"),
    "plain_runner": (lambda a: a + ["--islands", "1"], "plain"),
    "disparity": (lambda a: a[:1] + ["disparity"] + a[2:],
                  "disparity run type"),
    "profile": (lambda a: a[:2] + ["profile"] + a[2:], "synth profile"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_runner_refuses_without_a_multi_rank_form(run_files, tmp_path,
                                                  monkeypatch, name):
    """Under torchrun (WORLD_SIZE 2) what has no multi-rank form raises by
    name before any process group starts, and writes nothing."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    edit, match = REFUSALS[name]
    with pytest.raises(NotImplementedError, match=match):
        runner.main(edit(_runner_args(run_files, tmp_path / "out")))
    assert not (tmp_path / "out").exists()


def test_runner_refuses_dist_backend_in_one_process(run_files, tmp_path,
                                                    monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="--dist-backend"):
        runner.main(_runner_args(run_files, tmp_path / "out",
                                 "--dist-backend", "gloo"))
