"""Host-only modules shared with ``phdslam_tpu``, loaded by file path.

``config.py``, ``simdata.py``, ``io/loaders.py`` and ``io/logs.py`` import
nothing of JAX and nothing of their package, but importing them the usual
way would run ``phdslam_tpu/__init__.py``, which imports and configures JAX
(and ``filter/state.py`` imports flax). A machine that runs the port need
not have either, so each file is executed here under a private module name
instead. They are shared, not copied: a change to the JAX package's config
parser or log format is a change to the port's.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_JAX_PACKAGE = Path(__file__).resolve().parent.parent / "phdslam_tpu"


def _load(relpath: str, name: str):
    full = f"phdslam_tpu_torch._shared_{name}"
    if full in sys.modules:
        return sys.modules[full]
    spec = importlib.util.spec_from_file_location(full, _JAX_PACKAGE / relpath)
    mod = importlib.util.module_from_spec(spec)
    # registered before execution: dataclasses resolve their module by name
    sys.modules[full] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[full]
        raise
    return mod


config = _load("config.py", "config")
simdata = _load("simdata.py", "simdata")
loaders = _load("io/loaders.py", "loaders")
logs = _load("io/logs.py", "logs")

SlamConfig = config.SlamConfig
load_config = config.load_config
PHD_TYPE = config.PHD_TYPE
CPHD_TYPE = config.CPHD_TYPE
FASTSLAM_TYPE = config.FASTSLAM_TYPE
CV_MOTION = config.CV_MOTION
ACKERMAN_MOTION = config.ACKERMAN_MOTION
STATIC_MODEL = config.STATIC_MODEL
DYNAMIC_MODEL = config.DYNAMIC_MODEL
MIXED_MODEL = config.MIXED_MODEL
STATIC_MEASUREMENT = config.STATIC_MEASUREMENT
DYNAMIC_MEASUREMENT = config.DYNAMIC_MEASUREMENT
LOG0 = config.LOG0

make_scenario = simdata.make_scenario
generate_run = simdata.generate_run
write_run_files = simdata.write_run_files

MeasurementSet = loaders.MeasurementSet
load_measurements = loaders.load_measurements
load_controls = loaders.load_controls
load_timestamps = loaders.load_timestamps
load_trajectory = loaders.load_trajectory
pad_measurement_sets = loaders.pad_measurement_sets

write_state_estimate_log = logs.write_state_estimate_log
append_loop_time = logs.append_loop_time
append_metrics_jsonl = logs.append_metrics_jsonl
read_state_estimate_log = logs.read_state_estimate_log
