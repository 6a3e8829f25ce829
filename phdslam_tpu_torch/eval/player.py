"""Interactive log replay: a self-contained HTML player for a directory
of state_estimate logs.

The port's copy of ``phdslam_tpu/eval/player.py``'s HTML player
(``build_player``; host-only, it reads the logs through the port's own
``io/logs.py``; ``tests/test_torch_host.py`` holds the two equal). One
HTML file embeds the run's data as JSON and draws it on a canvas: time
slider, play/pause, arrow-key steps, particle cloud, MAP map with 3-sigma
ellipses, expected-trajectory trail, optional ground truth. With
``--gui``, the JAX package's matplotlib window instead (``LogPlayer``, a
copy; matplotlib is imported only there): play/pause, arrow-key steps and
speed, the particle cloud, weights and cardinality panels.

    python -m phdslam_tpu_torch.eval.player <log_dir> [out.html]
        [--truth simData.mat] [--stride N] [--gui] [--fps F]
        [--min-weight W]
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from phdslam_tpu_torch.io.logs import read_state_estimate_log

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>phdslam_tpu log player</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 12px; background:#111;
        color:#ddd; }}
 #wrap {{ max-width: 980px; margin: auto; }}
 canvas {{ background:#181818; border:1px solid #333; width:100%; }}
 .bar {{ display:flex; gap:10px; align-items:center; margin:8px 0; }}
 input[type=range] {{ flex:1; }}
 button {{ background:#2a6; border:none; color:#fff; padding:4px 14px;
          border-radius:4px; font-size:15px; cursor:pointer; }}
 #info {{ font-variant-numeric: tabular-nums; white-space:pre; }}
</style></head><body><div id="wrap">
<h3>phdslam_tpu — {title}</h3>
<div class="bar">
 <button id="play">&#9654;</button>
 <input type="range" id="t" min="0" max="{tmax}" value="0" step="1">
 <span id="info"></span>
</div>
<canvas id="c" width="960" height="640"></canvas>
<div class="bar" style="font-size:13px;color:#888">
 arrow keys: step &nbsp;|&nbsp; space: play/pause &nbsp;|&nbsp;
 green: expected pose + trail &nbsp;|&nbsp; grey dots: particles
 &nbsp;|&nbsp; orange: map features (3&sigma;) &nbsp;|&nbsp;
 blue x: ground truth
</div>
</div><script>
const DATA = {data};
const cv = document.getElementById('c'), cx = cv.getContext('2d');
const slider = document.getElementById('t'),
      info = document.getElementById('info'),
      btn = document.getElementById('play');
let playing = false, timer = null;

// world-to-canvas transform from the data extent
let xs = [], ys = [];
for (const f of DATA.frames) {{
  xs.push(f.pose[0]); ys.push(f.pose[1]);
  for (const m of f.map) {{ xs.push(m[1]); ys.push(m[2]); }}
}}
if (DATA.truth_lm) for (const p of DATA.truth_lm) {{
  xs.push(p[0]); ys.push(p[1]); }}
const pad = 2,
      x0 = Math.min(...xs)-pad, x1 = Math.max(...xs)+pad,
      y0 = Math.min(...ys)-pad, y1 = Math.max(...ys)+pad;
const sc = Math.min(cv.width/(x1-x0), cv.height/(y1-y0));
function W(x,y) {{ return [(x-x0)*sc, cv.height-(y-y0)*sc]; }}

function ellipse(m) {{
  // m = [w, x, y, c00, c01, c11]; 3-sigma ellipse from the 2x2 cov
  const [w,x,y,a,b,c] = m;
  const tr=a+c, det=a*c-b*b,
        l1=tr/2+Math.sqrt(Math.max(tr*tr/4-det,0)),
        l2=tr/2-Math.sqrt(Math.max(tr*tr/4-det,0));
  const ang = Math.atan2(l1-a, b||1e-12);
  const [px,py]=W(x,y);
  cx.beginPath();
  cx.ellipse(px,py,3*Math.sqrt(Math.max(l1,1e-9))*sc,
             3*Math.sqrt(Math.max(l2,1e-9))*sc,-ang,0,2*Math.PI);
  cx.stroke();
}}

function draw(t) {{
  const f = DATA.frames[t];
  cx.clearRect(0,0,cv.width,cv.height);
  // truth landmarks
  if (DATA.truth_lm) {{
    cx.strokeStyle='#59f'; cx.lineWidth=1.2;
    for (const p of DATA.truth_lm) {{
      const [px,py]=W(p[0],p[1]);
      cx.beginPath(); cx.moveTo(px-4,py-4); cx.lineTo(px+4,py+4);
      cx.moveTo(px-4,py+4); cx.lineTo(px+4,py-4); cx.stroke();
    }}
  }}
  // truth trajectory
  if (DATA.truth_traj) {{
    cx.strokeStyle='#347'; cx.beginPath();
    DATA.truth_traj.slice(0,t+1).forEach((p,i)=>{{
      const [px,py]=W(p[0],p[1]); i?cx.lineTo(px,py):cx.moveTo(px,py);}});
    cx.stroke();
  }}
  // particles
  cx.fillStyle='rgba(200,200,200,0.35)';
  for (const p of f.particles) {{
    const [px,py]=W(p[0],p[1]); cx.fillRect(px-1,py-1,2,2);
  }}
  // map ellipses
  cx.strokeStyle='#fa3'; cx.lineWidth=1;
  for (const m of f.map) ellipse(m);
  // expected trail + pose
  cx.strokeStyle='#3d6'; cx.lineWidth=2; cx.beginPath();
  DATA.frames.slice(0,t+1).forEach((g,i)=>{{
    const [px,py]=W(g.pose[0],g.pose[1]);
    i?cx.lineTo(px,py):cx.moveTo(px,py);}});
  cx.stroke();
  const [px,py]=W(f.pose[0],f.pose[1]);
  cx.fillStyle='#3d6'; cx.beginPath();
  cx.arc(px,py,5,0,2*Math.PI); cx.fill();
  cx.strokeStyle='#3d6'; cx.beginPath(); cx.moveTo(px,py);
  cx.lineTo(px+14*Math.cos(-f.pose[2]),py+14*Math.sin(-f.pose[2]));
  cx.stroke();
  info.textContent = `t=${{String(f.t).padStart(4)}}  ` +
    `features=${{String(f.map.length).padStart(3)}}  ` +
    `card=${{f.card.toFixed(1)}}`;
  slider.value = t;
}}

function step(d) {{
  let t = (+slider.value + d + DATA.frames.length) % DATA.frames.length;
  draw(t);
}}
slider.oninput = () => draw(+slider.value);
btn.onclick = toggle;
function toggle() {{
  playing = !playing;
  btn.innerHTML = playing ? '&#9646;&#9646;' : '&#9654;';
  if (playing) timer = setInterval(()=>step(1), 90);
  else clearInterval(timer);
}}
document.addEventListener('keydown', e => {{
  if (e.key==='ArrowRight') step(1);
  else if (e.key==='ArrowLeft') step(-1);
  else if (e.key===' ') {{ e.preventDefault(); toggle(); }}
}});
draw(0);
</script></body></html>
"""


def _project_disparity_record(d):
    """Project a disparity (12-DOF camera) log record onto the top-down
    (x, z) plane in place; 2-D SLAM records pass through untouched.
    Map-line layout: [w, m0, m1, m2, 3x3 cov column-major] -> synth 2-D
    rows [w, x, z, Cxx, Cxz, Czz] (cov cols 4+0, 4+6, 4+8)."""
    if d["pose"].size != 12:
        return d
    s = d["static"]
    if s.shape[1] == 13 and len(s):
        d["static"] = s[:, [0, 1, 3, 4, 10, 12, 12]]
    else:
        d["static"] = np.zeros((0, 7))
    d["pose"] = d["pose"][[0, 2, 5]]
    d["poses"] = d["poses"][:, [0, 2]]
    return d


def _card_estimate(d) -> float:
    """Cardinality estimate for one log record: a CPHD log's cardinality
    line is a real log-pmf (has variation) -> decode E[n]; a PHD log
    writes the all-zeros placeholder line (main.cpp:949-950) -> fall back
    to the intensity mass (static weight sum)."""
    cn = np.asarray(d.get("cardinality", ()))
    if cn.size > 1 and np.ptp(cn) > 0:
        pmf = np.exp(cn - cn.max())
        pmf /= pmf.sum()
        return float(np.sum(pmf * np.arange(cn.size)))
    return float(d["static"][:, 0].sum())


def build_player(log_dir: str, out_path: str = None, truth_mat: str = None,
                 stride: int = 1, max_particles: int = 256) -> str:
    """Bundle a log directory into a standalone interactive HTML player.

    Cardinality panel semantics shared with LogPlayer via _card_estimate:
    CPHD logs carry a real log-pmf -> E[n]; PHD logs carry the all-zeros
    placeholder line -> intensity mass.

    Embeds per-step: expected pose, decimated particle cloud, the MAP
    map's (w, mean, cov) rows, and the cardinality estimate; plus the
    ground-truth trajectory/landmarks when a simData .mat is given."""
    files = sorted(glob.glob(os.path.join(log_dir, "state_estimate*.log")))
    if not files:
        raise FileNotFoundError(f"no state_estimate logs in {log_dir}")
    frames = []
    for i, path in enumerate(files):
        if i % max(stride, 1):
            continue
        d = read_state_estimate_log(path)
        _project_disparity_record(d)
        w = d["static"][:, 0]
        sel = np.argsort(-w)[: min(len(w), 256)]
        sel = sel[w[sel] > 0.05]
        parts = d["poses"][:, :2]
        if len(parts) > max_particles:
            parts = parts[:: len(parts) // max_particles + 1]
        card = _card_estimate(d)
        frames.append(dict(
            t=i,
            pose=[round(float(v), 3) for v in d["pose"][:3]],
            particles=[[round(float(x), 2) for x in p] for p in parts],
            # row layout [w, mx, my, C00, C10, C01, C11] (cov col-major)
            # -> the JS ellipse's [w, x, y, c00, c01, c11]
            map=[[round(float(v), 3) for v in d["static"][j][[0, 1, 2,
                                                              3, 4, 6]]]
                 for j in sel],
            card=round(card, 2)))

    truth_traj = truth_lm = None
    if truth_mat and (os.path.isdir(truth_mat)
                      or truth_mat.endswith(".txt")):
        # disparity dataset truth: traj.txt + landmarks.txt, top-down (x, z)
        tdir = truth_mat if os.path.isdir(truth_mat) \
            else os.path.dirname(truth_mat)
        traj = np.loadtxt(os.path.join(tdir, "traj.txt"), comments="%")
        truth_traj = [[round(float(traj[t, 0]), 3),
                       round(float(traj[t, 2]), 3)]
                      for t in range(0, traj.shape[0], max(stride, 1))]
        lm_path = os.path.join(tdir, "landmarks.txt")
        if os.path.exists(lm_path):
            lms = np.loadtxt(lm_path, comments="%")
            truth_lm = [[round(float(q[0]), 3), round(float(q[2]), 3)]
                        for q in np.atleast_2d(lms)]
    elif truth_mat:
        from scipy.io import loadmat
        sim = loadmat(truth_mat)["sim"][0, 0]
        traj = sim["traj"]
        truth_traj = [[round(float(traj[0, t]), 3),
                       round(float(traj[1, t]), 3)]
                      for t in range(0, traj.shape[1], max(stride, 1))]
        gt = sim["groundTruth"][0, min(len(files) - 1,
                                       sim["groundTruth"].shape[1] - 1)]
        loc = gt[0, 0]["loc"]
        truth_lm = [[round(float(loc[0, j]), 3), round(float(loc[1, j]), 3)]
                    for j in range(loc.shape[1])]

    data = dict(frames=frames, truth_traj=truth_traj, truth_lm=truth_lm)
    out_path = out_path or os.path.join(log_dir, "player.html")
    html = _PAGE.format(title=os.path.basename(os.path.abspath(log_dir)),
                        tmax=len(frames) - 1,
                        data=json.dumps(data, separators=(",", ":")))
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


class LogPlayer:
    """Native matplotlib animated replay — the direct counterpart of the
    reference's GUI player (python/plot_phdslam.py:35-256: play/pause
    timer, estimated trajectory + 3-sigma feature ellipses over truth,
    particle scatter, particle-weight and cardinality panels), driven by
    the keyboard on any interactive backend: space = play/pause,
    left/right = step, up/down = speed, escape = quit. Frame stepping
    (`show_frame`) also works headlessly on Agg, which is how the tests
    exercise it; the HTML `build_player` remains the zero-dependency
    artifact for sharing runs.
    """

    def __init__(self, records, true_map=None, true_traj=None,
                 min_weight: float = 0.33, fps: float = 10.0,
                 max_ellipses: int = 256):
        import matplotlib.pyplot as plt
        from matplotlib.gridspec import GridSpec

        self.records = [_project_disparity_record(dict(r)) for r in records]
        self.n_steps = len(self.records)
        self.min_weight = float(min_weight)
        self.interval_ms = 1000.0 / float(fps)
        self.frame = 0
        self.playing = False
        self._timer = None

        self.est_traj_xy = np.stack(
            [r["pose"][:2] for r in self.records])
        # estimated map cardinality: CPHD pmf -> E[n], else intensity mass
        # (same branch as build_player, so GUI and HTML replays agree)
        self.card_est = np.array(
            [_card_estimate(r) for r in self.records])

        self.fig = plt.figure(figsize=(12, 6))
        gs = GridSpec(2, 4, figure=self.fig)
        self.ax = self.fig.add_subplot(gs[:, 0:2])
        self.ax_particles = self.fig.add_subplot(gs[0, 2])
        self.ax_weights = self.fig.add_subplot(gs[0, 3])
        self.ax_cn = self.fig.add_subplot(gs[1, 2:])

        # static background: truth (plot_phdslam.py:66-67)
        if true_map is not None and len(true_map):
            tm = np.asarray(true_map)
            self.ax.plot(tm[:, 0], tm[:, 1], "k*", ms=7, label="true map")
        if true_traj is not None:
            tt = np.asarray(true_traj)
            if tt.shape[0] in (2, 3) and tt.shape[1] > 3:
                tt = tt.T
            self.ax.plot(tt[:, 0], tt[:, 1], "k-", lw=1, alpha=0.5,
                         label="true traj")
        self.ax.set_aspect("equal")
        self.ax.set_title("world")

        # animated artists (the reference keeps a fixed pool of ellipse
        # lines, plot_phdslam.py:91-97; same idea here)
        (self.l_traj,) = self.ax.plot([], [], "r--", lw=1.2)
        (self.l_pose,) = self.ax.plot([], [], "rd", ms=8, mfc="none")
        (self.l_particles,) = self.ax.plot([], [], ",", color="tab:blue")
        self.l_ellipses = [self.ax.plot([], [], "b-", lw=0.7)[0]
                           for _ in range(max_ellipses)]
        (self.l_particles2,) = self.ax_particles.plot(
            [], [], ".", color="tab:blue", ms=2)
        self.ax_particles.set_title("particle cloud")
        (self.l_weights,) = self.ax_weights.plot([], [], "-",
                                                 color="tab:orange")
        self.ax_weights.set_title("particle weights")
        self.ax_cn.plot(np.arange(self.n_steps), self.card_est,
                        color="0.7", lw=0.8, label="all steps")
        (self.l_cn,) = self.ax_cn.plot([], [], "b-", lw=1.2,
                                       label="played")
        (self.l_cn_now,) = self.ax_cn.plot([], [], "bo", ms=5)
        self.ax_cn.set_title("estimated cardinality")
        self.ax_cn.set_xlabel("step")
        self.ax_cn.legend(loc="upper left", fontsize=8)
        self.fig.suptitle(self._title(0))
        self.fig.tight_layout()

        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self.show_frame(0)

    def _title(self, t):
        state = "playing" if self.playing else "paused"
        return (f"step {t + 1}/{self.n_steps}  [{state}]   "
                "space=play/pause  arrows=step/speed  esc=quit")

    def show_frame(self, t: int):
        """Render step t onto the animated artists
        (plot_phdslam.py:127-174 update_plot semantics)."""
        t = int(np.clip(t, 0, self.n_steps - 1))
        self.frame = t
        r = self.records[t]

        self.l_traj.set_data(self.est_traj_xy[: t + 1, 0],
                             self.est_traj_xy[: t + 1, 1])
        self.l_pose.set_data([r["pose"][0]], [r["pose"][1]])
        poses = r["poses"]
        self.l_particles.set_data(poses[:, 0], poses[:, 1])

        static = r["static"]
        keep = static[static[:, 0] >= self.min_weight] if len(static) \
            else static
        for i, line in enumerate(self.l_ellipses):
            if i < len(keep):
                row = keep[i]
                cov = np.array([[row[3], row[4]], [row[4], row[6]]])
                from phdslam_tpu_torch.eval.plots import _ellipse_points
                ex, ey = _ellipse_points(row[1:3], cov)
                line.set_data(ex, ey)
            else:
                line.set_data([], [])

        self.l_particles2.set_data(poses[:, 0], poses[:, 1])
        self.ax_particles.relim()
        self.ax_particles.autoscale_view()

        w = r["weights"]
        self.l_weights.set_data(np.arange(w.size), w)
        self.ax_weights.relim()
        self.ax_weights.autoscale_view()

        ts = np.arange(t + 1)
        self.l_cn.set_data(ts, self.card_est[: t + 1])
        self.l_cn_now.set_data([t], [self.card_est[t]])

        self.fig.suptitle(self._title(t))
        self.fig.canvas.draw_idle()

    def _tick(self):
        if not self.playing:
            return
        if self.frame + 1 >= self.n_steps:
            self.pause()
            return
        self.show_frame(self.frame + 1)

    def play(self):
        self.playing = True
        if self._timer is None:
            self._timer = self.fig.canvas.new_timer(
                interval=int(self.interval_ms))
            self._timer.add_callback(self._tick)
        self._timer.interval = int(self.interval_ms)
        self._timer.start()
        self.fig.suptitle(self._title(self.frame))

    def pause(self):
        self.playing = False
        if self._timer is not None:
            self._timer.stop()
        self.fig.suptitle(self._title(self.frame))
        self.fig.canvas.draw_idle()

    def _on_key(self, event):
        if event.key == " ":
            self.pause() if self.playing else self.play()
        elif event.key == "right":
            self.pause()
            self.show_frame(self.frame + 1)
        elif event.key == "left":
            self.pause()
            self.show_frame(self.frame - 1)
        elif event.key == "up":
            self.interval_ms = max(10.0, self.interval_ms / 1.5)
            if self.playing:
                self.play()
        elif event.key == "down":
            self.interval_ms = min(2000.0, self.interval_ms * 1.5)
            if self.playing:
                self.play()
        elif event.key == "escape":
            import matplotlib.pyplot as plt
            self.pause()
            plt.close(self.fig)

    def run(self):
        """Block in the GUI event loop (the reference's app.exec_(),
        plot_phdslam.py:252-256). Requires an interactive backend."""
        import matplotlib.pyplot as plt
        self.play()
        plt.show()


def _load_records(log_dir: str):
    files = sorted(glob.glob(os.path.join(log_dir, "state_estimate*.log")))
    if not files:
        raise FileNotFoundError(f"no state_estimate logs in {log_dir}")
    return [read_state_estimate_log(f) for f in files]


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log_dir")
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--truth", default=None,
                    help="simData .mat for ground-truth overlay")
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--gui", action="store_true",
                    help="open the native matplotlib animated player "
                         "instead of writing an HTML bundle (needs an "
                         "interactive backend / DISPLAY)")
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--min-weight", type=float, default=0.33)
    a = ap.parse_args(argv)
    if a.gui:
        import matplotlib
        if matplotlib.get_backend().lower().startswith("agg"):
            print("no interactive backend available (DISPLAY unset?); "
                  "omit --gui to build the HTML player instead")
            return 1
        true_map = true_traj = None
        if a.truth:
            from scipy.io import loadmat
            sim = loadmat(a.truth)["sim"][0, 0]
            true_traj = sim["traj"][:2]
            gt = sim["groundTruth"][0, -1]
            true_map = gt[0, 0]["loc"][:2].T
        LogPlayer(_load_records(a.log_dir), true_map=true_map,
                  true_traj=true_traj, fps=a.fps,
                  min_weight=a.min_weight).run()
        return 0
    out = build_player(a.log_dir, a.out, truth_mat=a.truth, stride=a.stride)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
