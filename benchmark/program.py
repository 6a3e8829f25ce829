"""The system under test, as the benchmark drives it: the only module of
the benchmark that imports ``phdslam_tpu_torch``.

It turns a configuration file's cfg keys into the port's ``SlamConfig``
through the port's own cfg parser, creates the state, builds the
measurement sets, calls ``filter/step.py::slam_step`` (or, over ranks,
``parallel/mesh.py::sharded_step``) and reads back what the judge needs.
"""

from __future__ import annotations


def config(c: dict):
    """The port's SlamConfig of the cfg dict c; every key has to be one
    the port's cfg dialect knows, and has to come out as given."""
    from phdslam_tpu_torch.config import _KEY_MAP, parse_config_text
    text = "\n".join(f"{k} = {v}" for k, v in c.items())
    cfg = parse_config_text(text)
    for k, v in c.items():
        field = _KEY_MAP.get(k)
        if field is None:
            raise ValueError(f"cfg key {k} is not in the port's cfg dialect")
        if float(getattr(cfg, field)) != float(v):
            raise ValueError(f"cfg key {k}: {v} came out as "
                             f"{getattr(cfg, field)}")
    return cfg


def load_kernels(device):
    """Build (on the first run in a checkout) and load the kernel library;
    returns the build's info. Nothing to load on the CPU."""
    if device.type != "cuda":
        return dict(built=False, seconds=0.0)
    from phdslam_tpu_torch.kernels import _build
    info = _build.library()[1]
    return dict(built=info["built"], seconds=info["seconds"])


class Program:
    """One rank's filter: ``cfg`` of all particles; ``mesh`` None or the
    port's ParticleMesh (this rank holds P / W rows)."""

    def __init__(self, c: dict, device, mesh=None):
        self.cfg = config(c)
        self.device = device
        self.mesh = mesh
        if mesh is not None:
            from phdslam_tpu_torch.parallel.mesh import sharded_step
            self._sharded = sharded_step(self.cfg, mesh)

    def initial_state(self):
        from phdslam_tpu_torch.filter.state import SlamState
        state = SlamState.create(self.cfg, self.device)
        if self.mesh is not None:
            from phdslam_tpu_torch.parallel.mesh import shard_state
            state = shard_state(state, self.mesh)
        return state

    def measurements(self, rb, valid):
        import numpy as np

        from phdslam_tpu_torch.filter.state import Measurements
        return Measurements.from_numpy(
            rb, np.zeros(rb.shape[0], np.int32), valid, self.device)

    def step(self, state, control, z, dt, do_predict, noise, z_prev):
        """(state', aux): one SLAM step with the given draws."""
        if self.mesh is not None:
            return self._sharded(state, control, z, dt, do_predict,
                                 noise=noise, z_prev=z_prev)
        from phdslam_tpu_torch.filter import step as S
        return S.slam_step(state, control, z, dt, do_predict, self.cfg,
                           noise=noise, z_prev=z_prev)

    @staticmethod
    def rows(state):
        """This rank's rows: (pose, log weights, six map channels,
        resample indices)."""
        m = state.map_static
        return (state.pose, state.log_weights,
                (m.w, m.mx, m.my, m.c00, m.c01, m.c11), state.resample_idx)

    def take_traffic(self):
        """The mesh's traffic record since the last take, or None."""
        return None if self.mesh is None else self.mesh.take_traffic()


def make_mesh(device, rank: int, world: int, init_method: str):
    from phdslam_tpu_torch.parallel.mesh import make_mesh as mk
    return mk(device=device, rank=rank, world_size=world,
              init_method=init_method)
