"""The evidence entry points end to end on the CPU, through the port's real
filter on the kernels' plain versions, at tiny shapes (``--smoke``): each
entry has every key of the JAX script's record (``results/``), every
number finite; ``--device cuda`` raises without a GPU; a cut CPU
reference leg is named; entries merge into the results file."""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

from phdslam_tpu_torch.evidence import common as C

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUND3_RECORD = os.path.join(REPO, "results", "round3_evidence.json")

# (module, arguments, key of the entry, the JAX record holding its keys)
SMOKE_RUNS = [
    ("round3", ("vmap",), "vmap", ROUND3_RECORD),
    ("round3", ("merge",), "merge_modes", ROUND3_RECORD),
    ("round3", ("variants",), "variants", ROUND3_RECORD),
    ("round3", ("parity",), "parity_config2", ROUND3_RECORD),
    ("round3", ("cphd_cpu",), "cphd_cpu_oracle", ROUND3_RECORD),
    ("mixed", (), "mixed", ROUND3_RECORD),
    ("mixed", ("--labeled",), "mixed_labeled", ROUND3_RECORD),
    ("mixed", ("--informed", "--set", "keepOobDynamic=1"),
     "mixed_informed_keepOobDynamic1", None),
    ("disparity", (), "disparity", ROUND3_RECORD),
    ("disparity", ("--oracle",), "disparity_cpu_oracle", ROUND3_RECORD),
    ("fastslam", ("--cell", "2.0", "0.25", "2"), "c2_s0.25_f2",
     os.path.join(REPO, "results", "fastslam_grid.json")),
    ("fastslam", ("--cell", "2.0", "0.25", "0"), "c2_s0.25_f0",
     os.path.join(REPO, "results", "fastslam_grid.json")),
    ("cphd_dwell", (), "cphd_dwell",
     os.path.join(REPO, "results", "cphd_dwell.json")),
    ("ospa_latency", (), "ospa_latency",
     os.path.join(REPO, "results", "ospa_latency.json")),
]
CPU_LEGS = ("round3", "mixed", "disparity")


def main_of(name):
    import importlib
    return importlib.import_module(f"phdslam_tpu_torch.evidence.{name}").main


def leaves(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from leaves(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from leaves(v)
    else:
        yield obj


def assert_keys(record, entry, path=""):
    for k, v in record.items():
        assert k in entry, path + k
        if isinstance(v, dict):
            assert_keys(v, entry[k], f"{path}{k}.")


@pytest.mark.parametrize("name, args, key, record", SMOKE_RUNS,
                         ids=[" ".join((r[0],) + r[1]) for r in SMOKE_RUNS])
def test_entry_point_smoke(name, args, key, record, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = [*args, "--smoke", "--device", "cpu"]
    if name in CPU_LEGS:
        argv += ["--cpu-steps", "2"]
    out = main_of(name)(argv)
    entry = out[key]
    if record is not None:
        with open(record) as f:
            rec = json.load(f)
        assert_keys(rec.get(key, rec), entry)
    assert entry["device"] == "cpu" and entry["power_limit_w"] is None
    numbers = [v for v in leaves(entry)
               if isinstance(v, (int, float)) and not isinstance(v, bool)]
    assert numbers and all(np.isfinite(numbers))
    assert not os.path.exists(tmp_path / "results")   # --smoke writes nothing


@pytest.mark.parametrize("name", ["round3", "mixed", "disparity",
                                  "fastslam", "cphd_dwell", "ospa_latency"])
def test_cuda_without_gpu_raises(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_of(name)(["--smoke"])
    assert not os.listdir(tmp_path)


def test_cpu_leg_cut_named(tmp_path, monkeypatch):
    """round3 parity with its CPU reference cut to 2 steps names the cut
    and still scores every run."""
    monkeypatch.chdir(tmp_path)
    entry = main_of("round3")(["parity", "--smoke", "--device", "cpu",
                               "--cpu-steps", "2"])["parity_config2"]
    assert entry["cpu_steps"] == 2 and entry["n_runs"] == 2
    assert np.isfinite(entry["cpu_pose_late_mean"])


def test_merge_json(tmp_path):
    """Entries merge into one results file under their keys, each with
    the device fields; a later entry replaces its key only."""
    out = str(tmp_path / "r" / "port_evidence.json")
    fields = dict(device="cpu", power_limit_w=None)
    C.merge_json(dict(a=dict(x=1.0), b=dict(y=2)), out, fields)
    C.merge_json(dict(a=dict(x=3.0)), out, fields)
    with open(out) as f:
        assert json.load(f) == dict(a=dict(x=3.0, **fields),
                                    b=dict(y=2, **fields))
    assert not os.path.exists(out + ".tmp")


def test_merge_json_into_previous(tmp_path):
    """A merge function builds each entry from the file's: FastSLAM's
    cells add up under one key, and a mixed run that skipped its CPU leg
    keeps the earlier CPU numbers."""
    from phdslam_tpu_torch.evidence import mixed
    out = str(tmp_path / "port_evidence.json")
    cells = lambda grid, cell: dict(grid, **cell)
    C.merge_json(dict(fastslam_grid=dict(a=1)), out, {}, merge=cells)
    C.merge_json(dict(fastslam_grid=dict(b=2)), out, {}, merge=cells)
    C.merge_json(dict(mixed=dict(cpu_ms_per_step=5.0, cpu_pose_mean=1.0,
                                 pose_mean=1.0)), out, {})
    C.merge_json(dict(mixed=dict(cpu_ms_per_step=None, cpu_pose_mean=None,
                                 pose_mean=2.0)), out, {},
                 merge=mixed.keep_cpu_numbers)
    with open(out) as f:
        assert json.load(f) == dict(
            fastslam_grid=dict(a=1, b=2),
            mixed=dict(cpu_ms_per_step=5.0, cpu_pose_mean=1.0,
                       pose_mean=2.0))



def test_power_limit_parse():
    assert C.power_limit_w("NVIDIA H100 80GB HBM3, 700.00 W") == 700.0


def _nvidia_smi(monkeypatch, returncode, stdout, stderr=""):
    """subprocess.run answering as nvidia-smi would; records the argv."""
    calls = []

    def run(argv, **kw):
        calls.append(argv)
        return subprocess.CompletedProcess(argv, returncode, stdout, stderr)

    monkeypatch.setattr(C.subprocess, "run", run)
    return calls


def test_gpu_line_takes_the_first_card(monkeypatch):
    calls = _nvidia_smi(monkeypatch, 0, "NVIDIA H100 80GB HBM3, 700.00 W\n"
                        "NVIDIA H100 80GB HBM3, 500.00 W\n")
    assert C.gpu_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert calls == [["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]


def test_gpu_line_raises_when_nvidia_smi_fails(monkeypatch):
    _nvidia_smi(monkeypatch, 9, "", "No devices were found")
    with pytest.raises(RuntimeError, match="No devices were found"):
        C.gpu_line()


def test_device_fields_on_a_card(monkeypatch):
    """A CUDA device's fields: the card's name and its power limit in
    watts, split from gpu_line (a torch.device needs no GPU to build)."""
    monkeypatch.setattr(C, "gpu_line",
                        lambda: "NVIDIA H100 80GB HBM3, 650.00 W")
    assert C.device_fields(torch.device("cuda", 0)) == dict(
        device="NVIDIA H100 80GB HBM3", power_limit_w=650.0)
    assert C.device_fields(torch.device("cpu")) == dict(
        device="cpu", power_limit_w=None)


def test_out_key_and_overrides():
    """mixed's output key: the script's naming of its flags."""
    from phdslam_tpu_torch.evidence import mixed
    over = mixed.parse_overrides(["keepOobDynamic=1", "birthWeight=0.05"])
    assert mixed.out_key(False, True, over) \
        == "mixed_labeled_birthWeight0.05_keepOobDynamic1"
    assert mixed.out_key(True, False, {}) == "mixed_informed"
