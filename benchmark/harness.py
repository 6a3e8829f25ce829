"""One run of one cell: set-up, the measured window, the traced steps and
the check of the outputs.

What a timed step does is what an online robot's filter does each step:
the step's measurement set arrives on the host as NumPy arrays, goes to
the device (``Measurements.from_numpy``), the step's random draws are
made on the device from the run's seed, ``slam_step`` runs with the
previous set as ``z_prev``, and the expected pose is read back to the
host. A step's latency runs from its set on the host to its pose there.

Set-up: import, load the kernel library (the first run in a checkout
builds it), generate the scene on the host, create the state, and run
the stream's first 3 steps. The window then continues the same stream
for ``--seconds`` seconds, with nothing new to build.

Over W ranks every rank runs ``sharded_step`` on its P / W rows; the
measurements are replicated and the global draws are the same on every
rank. Rank 0's clock ends the window: every 8 steps it tells the others,
over a host (gloo) group, whether to stop.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from benchmark import judge, scene
from benchmark import trace as T

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
WARMUP = 3
#: steps between two checks of rank 0's clock over ranks
STOP_EVERY = 8
#: profiled steps of a traced run
PROFILED = 16
#: window steps judged besides the last, drawn from the seed
SAMPLED = 4
BANNED = ("jax", "jaxlib", "flax", "phdslam_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict                 # cfg keys as run (all particles)
    traffic: dict
    limits: dict
    end_to_end: list          # BENCHMARK.json entries reported here
    per_layer: list


def _reported(entries, name):
    return [e for e in entries if name in e.get("workloads", [name])]


def load_cell(name: str, root: Path = REPO) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its
    configuration, traffic and limits files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"({', '.join(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfile = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    cfg = dict(cfile["cfg"])
    cfg["n_particles"] = int(cfg["n_particles"]) * int(w["chips"])
    cfg["clutter_rate"] = float(traffic["clutter"])
    return Cell(name=name, chips=int(w["chips"]), cfg=cfg, traffic=traffic,
                limits=limits,
                end_to_end=_reported(bench["end_to_end"], name),
                per_layer=_reported(bench["per_layer"], name))


def load_metric(name: str):
    """The reader ``read(ctx)`` of per-layer metric ``name``
    (``benchmark/metrics/<name>.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def p95(values) -> float:
    """The 95th percentile of all values (linear between order
    statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def seed_seq(seed: int, *tag):
    return np.random.SeedSequence([seed % (1 << 64), *tag])


def n_steps_for(seconds: float) -> int:
    """Steps in the scene: the window at 1 ms a step, and the set-up's and
    the traced run's steps."""
    return WARMUP + int(seconds * 1000) + PROFILED + 1


class Rank:
    """One process's share of a run. ``mesh`` is the port's ParticleMesh
    over W ranks, or None."""

    def __init__(self, cell: Cell, seed: int, seconds: float, device,
                 mesh=None, ctl_group=None):
        import torch

        from benchmark import program
        self.torch = torch
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device, self.mesh, self.ctl_group = device, mesh, ctl_group
        self.rank = 0 if mesh is None else mesh.rank
        self.world = 1 if mesh is None else mesh.world_size
        self.build = program.load_kernels(device)
        self.stream = scene.make_stream(
            cell.traffic, int(seed_seq(seed, 0).generate_state(1)[0]),
            n_steps_for(seconds), int(cell.cfg["max_measurements"]))
        x0, y0, yaw0 = (float(v) for v in self.stream.start_pose)
        cell.cfg.update(initial_x=x0, initial_y=y0, initial_yaw=yaw0)
        self.P = int(cell.cfg["n_particles"])
        self.prog = program.Program(cell.cfg, device, mesh)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed_seq(seed, 1).generate_state(1)[0]))
        self.state = self.prog.initial_state()
        self.t = 0
        self.z_prev = None
        self.kept = {}           # step -> (inputs, outputs) to judge
        self.keep_at = {0}
        self.last = self.fired = self.full = None
        self.lat, self.disp = [], []

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def one_step(self, spans=False):
        """Step self.t; returns its latency in s."""
        torch = self.torch
        span = torch.profiler.record_function if spans \
            else (lambda name: nullcontext())
        st = self.stream
        t = self.t
        if t >= st.rb.shape[0]:
            raise RuntimeError(f"the scene ran out of steps at {t}")
        t0 = time.perf_counter()
        with span("upload"):
            z = self.prog.measurements(st.rb[t], st.valid[t])
        with span("draws"):
            normals = torch.randn((1, self.P, 2), generator=self.gen,
                                  device=self.device)
            uniforms = torch.rand((self.P,), generator=self.gen,
                                  device=self.device)
        control = (float(st.controls[t, 0]), float(st.controls[t, 1]))
        state_in = self.state
        t1 = time.perf_counter()
        with span("dispatch"):
            state, aux = self.prog.step(state_in, control, z, self.dt,
                                        t > 0, (normals, uniforms),
                                        self.z_prev)
        t2 = time.perf_counter()
        with span("pose_read"):
            aux.expected_pose.cpu()
        t3 = time.perf_counter()
        rec = (t, state_in, control, (normals, uniforms), state, aux)
        if t in self.keep_at:
            self.kept[t] = rec
        self.last = rec
        # the step is done (its pose is on the host): reading its trigger
        # waits for nothing
        if bool(aux.resampled):
            self.fired = rec
        if int(st.count[t]) == int(self.cell.cfg["max_measurements"]):
            self.full = rec
        self.state, self.z_prev = state, z
        self.t = t + 1
        self.disp.append(t2 - t1)
        return t3 - t0

    @property
    def dt(self):
        return float(self.cell.traffic["dt"])

    def warm_up(self):
        """The stream's first WARMUP steps; returns the last one's
        latency."""
        for _ in range(WARMUP):
            lat = self.one_step()
        self.sync()
        return lat

    def pick_samples(self, warm_s: float):
        """SAMPLED window steps to judge, drawn from the seed among the
        steps the window will surely reach (half of the count rank 0's
        last warm-up step's pace gives)."""
        if self.mesh is not None:
            box = [warm_s]
            self.torch.distributed.broadcast_object_list(
                box, 0, group=self.ctl_group)
            warm_s = box[0]
        n = max(1, int(self.seconds / max(2.0 * warm_s, 1e-3)))
        rng = np.random.default_rng(seed_seq(self.seed, 2))
        picks = rng.choice(n, size=min(SAMPLED, n), replace=False)
        self.keep_at |= {WARMUP + int(p) for p in picks}

    def _stop(self, t0, done: int) -> bool:
        if self.mesh is None:
            return time.perf_counter() - t0 >= self.seconds
        if done % STOP_EVERY:
            return False
        torch = self.torch
        flag = torch.tensor([time.perf_counter() - t0 >= self.seconds],
                            dtype=torch.int32)
        torch.distributed.broadcast(flag, 0, group=self.ctl_group)
        return bool(flag[0])

    def window(self):
        """Steps until rank 0's clock passes --seconds; returns (steps,
        window s)."""
        self.lat, self.disp = [], []
        self.prog.take_traffic()
        t0 = time.perf_counter()
        n = 0
        while True:
            self.lat.append(self.one_step())
            n += 1
            if self._stop(t0, n):
                break
        return n, time.perf_counter() - t0

    def profile(self):
        """PROFILED steps under torch.profiler; returns the Trace and the
        steps' inputs (n_valid per step)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        counts = []
        with profile(activities=acts) as prof:
            for _ in range(PROFILED):
                counts.append(int(self.stream.count[self.t]))
                with torch.profiler.record_function("step"):
                    self.one_step(spans=True)
            self.sync()
        return T.from_profiler(prof), counts

    # ------------------------------------------------------- the check --

    def global_rows(self, state):
        """The global (pose, lw, map, idx) of a state on rank 0 (None on
        the other ranks); every rank calls it."""
        rows = self.prog.rows(state)
        flat = [rows[0], rows[1], *rows[2], rows[3]]
        if self.mesh is not None:
            flat = [self._gather(x) for x in flat]
            if self.rank != 0:
                return None
        return dict(pose=flat[0], lw=flat[1], map=tuple(flat[2:8]),
                    idx=flat[8])

    def _gather(self, x):
        torch = self.torch
        x = x.contiguous()
        out = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
        torch.distributed.all_gather_into_tensor(out, x)
        return out

    def judged(self):
        """[(step, inputs, outputs)] global on rank 0: the first step, the
        sampled window steps reached, the last step, the latest step whose
        resample fired and the latest whose set filled max_measurements."""
        recs = dict(self.kept)
        for rec in (self.last, self.fired, self.full):
            if rec is not None:
                recs[rec[0]] = rec
        out = []
        for t in sorted(recs):
            _, s_in, control, (normals, uniforms), s_out, aux = recs[t]
            g_in = self.global_rows(s_in) if t > 0 else None
            g_out = self.global_rows(s_out)
            if self.rank != 0:
                continue
            st = self.stream
            zr = self.torch.as_tensor(st.rb[t, :, 0], device=self.device)
            zb = self.torch.as_tensor(st.rb[t, :, 1], device=self.device)
            inp = dict(control=control, zr=zr, zb=zb,
                       count=int(st.count[t]), do_predict=t > 0,
                       normals=normals[0], uniforms=uniforms)
            if g_in is None:     # the start: the reference's own state
                from benchmark import reference as R
                pose, lw, m = R.initial_state(self.cell.cfg, self.P,
                                              self.device)
                inp.update(pose=pose, lw=lw, map=tuple(m))
            else:
                inp.update(pose=g_in["pose"], lw=g_in["lw"],
                           map=g_in["map"])
            outp = dict(pose=g_out["pose"], lw=g_out["lw"],
                        map=g_out["map"], idx=g_out["idx"],
                        expected_pose=aux.expected_pose,
                        neff=float(aux.neff), resampled=bool(aux.resampled))
            out.append((t, inp, outp))
        return out

    def check(self, with_control=False):
        """(correct, checks, (steps judged, how many failed)) on rank 0;
        (None, None, None) on the others. Frees the program's live state
        first. ``with_control``: also the control's numbers on the same
        steps, in self.readings."""
        self.state = None
        self.z_prev = None
        steps = self.judged()
        self.kept = {}
        self.last = self.fired = self.full = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()
        if self.rank != 0:
            return None, None, None
        from benchmark import reference as R
        R.check_config(self.cell.cfg)
        per = [judge.judge_step(inp, outp, self.cell.cfg, self.dt)
               for _, inp, outp in steps]
        ok, checks = judge.verdict(judge.widest(per), self.cell.limits)
        self.readings = dict(program=judge.widest(per))
        if with_control:
            self.readings["control"] = judge.widest(
                [judge.judge_step(inp, control_outputs(inp, self.cell.cfg,
                                                       self.dt),
                                  self.cell.cfg, self.dt)
                 for _, inp, _ in steps])
        n_bad = sum(not judge.verdict(p, self.cell.limits)[0] for p in per)
        return ok, checks, ([t for t, _, _ in steps], n_bad)


def control_outputs(inp, c, dt):
    """The control in the program's place: the reference's step computed
    at TF32's precision from the same inputs."""
    from benchmark import reference as R
    pose, lw, m, idx, ep, neff, fired = R.step(
        inp["pose"], inp["lw"], R.Map(*inp["map"]), inp["control"],
        inp["zr"], inp["zb"], inp["count"], inp["do_predict"],
        inp["normals"], inp["uniforms"], c, dt, R.TF32)
    return dict(pose=pose, lw=lw, map=tuple(m), idx=idx, expected_pose=ep,
                neff=neff, resampled=fired)


def per_step_work(cell: Cell, counts, world: int):
    """The select's and the merge's bound ms over the profiled steps (one
    rank's P / W rows each)."""
    from benchmark import counts as C
    from benchmark.reference import k1_of
    P = cell.cfg["n_particles"] // world
    F = int(cell.cfg["max_features"])
    M = int(cell.cfg["max_measurements"])
    k1 = k1_of(cell.cfg)
    sel_ms = merge_ms = 0.0
    for n in counts:
        if n == 0:
            continue
        sel_ms += C.bound_ms(C.select_bytes(P, F, M, k1),
                             C.select_ops(P, F, n, k1))
        merge_ms += C.bound_ms(C.merge_bytes(P, C.pool_size(F, M, k1), F),
                               0)
    return sel_ms, merge_ms


def run_rank(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, mesh=None, ctl_group=None, with_control=False):
    """One rank's whole run; returns the result dict on rank 0 (the
    others return their device figures for rank 0 to fold in)."""
    import torch
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    rk = Rank(cell, seed, seconds, device, mesh, ctl_group)
    rk.pick_samples(rk.warm_up())
    if mesh is not None:
        torch.distributed.barrier(group=ctl_group)
    setup_s = time.monotonic() - t_start
    n, win_s = rk.window()
    rk.sync()
    lat, disp = list(rk.lat), list(rk.disp)
    traffic = rk.prog.take_traffic()
    tr = counts = None
    if traced:
        tr, counts = rk.profile()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    mine = dict(peak=peak, busy_us=T.busy_us(tr) if tr else 0.0,
                window_us=tr.window_us if tr else 0.0)
    ok, checks, judged = rk.check(with_control)
    if mesh is not None:
        figures = [None] * rk.world
        torch.distributed.all_gather_object(figures, mine, group=ctl_group)
    else:
        figures = [mine]
    bad = banned_modules()
    if bad:
        raise SystemExit(f"modules of {', '.join(bad)} are loaded")
    if rk.rank != 0:
        return None
    res = dict(setup_s=setup_s, steps=n, window_s=win_s,
               step_ms=win_s * 1e3 / n, step_ms_p95=p95(lat) * 1e3,
               build=rk.build, cut=int(rk.stream.n_cut), judged=judged,
               correct=ok, checks=checks, readings=rk.readings,
               peak=max(f["peak"] for f in figures))
    if traced:
        sel_ms, merge_ms = per_step_work(cell, counts, rk.world)
        ctx = dict(trace=tr, steps=PROFILED, wall_ms=win_s * 1e3 / n,
                   dispatch_ms=float(np.mean(disp)) * 1e3,
                   select_bound_ms=sel_ms, merge_bound_ms=merge_ms,
                   traffic=traffic,
                   window_steps=n, world=rk.world)
        res["per_layer"] = {}
        for m in cell.per_layer:
            v = load_metric(m["name"])(ctx)
            if v is not None:
                res["per_layer"][m["name"]] = (v, m["unit"])
        res["busy_s"], res["trace_window_s"] = (
            float(np.mean([f[k] for f in figures])) / 1e6
            for k in ("busy_us", "window_us"))
        res["breakdown"] = dict(
            device_ops=T.top_ops(tr),
            idle_gaps=[[n_, us / 1e6] for n_, us in T.idle_gaps(tr)[:10]])
    return res


def result_line(cell: Cell, res: dict, traced: bool, device) -> dict:
    """The last line of a run's standard output."""
    import torch
    if traced:
        metrics = {k: dict(value=v, unit=u)
                   for k, (v, u) in res["per_layer"].items()}
    else:
        metrics = {e["name"]: dict(value=res[e["name"]], unit=e["unit"])
                   for e in cell.end_to_end}
    dev = dict(platform="gpu" if device.type == "cuda" else "cpu",
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=cell.chips, memory_peak_bytes=int(res["peak"]))
    if traced:
        dev.update(busy_s=res["busy_s"], window_s=res["trace_window_s"])
    line = dict(correct=bool(res["correct"]), attempted=res["steps"],
                failed=res["judged"][1],
                metrics=metrics, device=dev)
    if traced:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


def checks_text(checks: dict) -> str:
    return "\n".join(f"check {k} {v['value']!r} limit {v['limit']!r}"
                     for k, v in checks.items())
