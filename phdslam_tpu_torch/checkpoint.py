"""Checkpoint / resume of the full filter state: the port's counterpart of
``phdslam_tpu/checkpoint.py``.

Every K steps the runners write ``ckpt_<step>.npz`` (atomic rename) with
the state's tensors by field name, the random generator's state and the
step; the last ``keep`` files stay. The JAX package pickles its pytree's
treedef beside the leaves; here the file records which state it holds
(``kind``: ``slam`` for a ``SlamState``, ``disparity`` for a
``DisparityState``) and the field names rebuild it, so nothing is
unpickled. A ``None`` field (the CPHD cardinalities on the PHD path) is
absent from the file. The generator's state replaces the JAX key: a CUDA
generator's is its seed and Philox offset, a CPU one's the Mersenne
Twister state; ``torch.Generator.set_state`` takes it back.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from phdslam_tpu_torch import bridge
from phdslam_tpu_torch.filter.disparity import DisparityState

_STATE = "state."


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        elif v is not None:
            out[prefix + k] = v
    return out


def _unflatten(flat):
    out = {}
    for k, v in flat.items():
        *parents, leaf = k.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _ckpts(directory):
    return sorted(p for p in os.listdir(directory)
                  if p.startswith("ckpt_") and p.endswith(".npz"))


def save_checkpoint(directory: str, step: int, state, generator,
                    keep: int = 3) -> str:
    """Write ``directory/ckpt_<step:06d>.npz`` (a temporary file renamed
    into place) and keep the last ``keep`` checkpoints. Returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    if isinstance(state, DisparityState):
        kind, fields = "disparity", bridge.disparity_state_to_numpy(state)
    else:
        kind, fields = "slam", bridge.state_to_numpy(state)
    payload = {_STATE + k: v for k, v in _flatten(fields).items()}
    payload["kind"] = np.asarray(kind)
    payload["generator"] = generator.get_state().numpy()
    payload["step"] = np.asarray(step)
    path = os.path.join(directory, f"ckpt_{step:06d}.npz")
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)
    for old in _ckpts(directory)[:-keep]:
        os.remove(os.path.join(directory, old))
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    ckpts = _ckpts(directory)
    return os.path.join(directory, ckpts[-1]) if ckpts else None


def restore_checkpoint(path: str, device="cuda") -> Tuple[
        object, torch.Tensor, int]:
    """Returns (state on ``device``, the generator's state, step). The
    generator state is a CPU uint8 tensor for ``Generator.set_state``."""
    with np.load(path) as data:
        kind = str(data["kind"])
        fields = _unflatten({k[len(_STATE):]: data[k] for k in data.files
                             if k.startswith(_STATE)})
        gen_state = torch.from_numpy(data["generator"].copy())
        step = int(data["step"])
    device = torch.device(device)
    if kind == "disparity":
        return (bridge.disparity_state_from_numpy(fields, device), gen_state,
                step)
    if kind != "slam":
        raise ValueError(f"{path}: unknown state kind {kind!r}")
    for name in ("cardinality", "cn_birth"):
        fields.setdefault(name, None)
    return bridge.state_from_numpy(fields, device), gen_state, step


def resume(directory: str, device, generator, state):
    """The latest checkpoint in ``directory``: (its state, the step after
    it), with ``generator`` set back to its state there; (state, 0) where
    there is none. What the runners' ``--resume`` does."""
    latest = latest_checkpoint(directory)
    if latest is None:
        return state, 0
    state, gen_state, step = restore_checkpoint(latest, device)
    generator.set_state(gen_state)
    print(f"resumed from {latest} at step {step + 1}")
    return state, step + 1
