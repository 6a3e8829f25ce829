"""The comparison that decides ``correct``.

For each compared step the reference (``reference.py``) recomputes, from
the step's input state and the very inputs the program was given
(measurements, odometry, random draws), the particles after the update,
the normalised weights, nEff, the expected pose, the resample's trigger
and its cumulative weights. The program's outputs of that step are
judged against them: each output row j is compared with the reference's
particle at the program's own resample index idx[j], and each index with
the reference's cumulative weights. Six numbers per step, the widest of
the steps compared:

- ``pose_gap``: largest |pose - reference pose| of any particle (x, y in
  m, heading in rad): the motion prediction, and the resample's gather.
- ``map_differing``: share of particles whose map differs from the
  reference's beyond rtol 2e-4 / atol 1e-5 in any channel of any slot:
  the pre-update, the top-k select, the births and the merge.
- ``weight_gap``: largest |log weight - reference's|: the increments,
  the normalisation and, after a resample, the uniform weights.
- ``neff_gap``: |nEff - reference's| / reference's.
- ``resample_gap``: largest distance, in units of the mean weight 1 / P,
  by which slot j's position (j + u_j) / P lies outside the reference's
  cumulative-weight interval of the particle the program picked; P where
  the program resampled and the reference did not, or the reverse.
- ``pose_estimate_gap``: largest |expected pose - reference's| (m, rad).

nEff within 1e-4 (relative) of the threshold may fire either way: the
program's own trigger is then judged.
"""

from __future__ import annotations

import math

import torch

from benchmark import reference as R

NAMES = ("pose_gap", "map_differing", "weight_gap", "neff_gap",
         "resample_gap", "pose_estimate_gap")
RTOL, ATOL = 2e-4, 1e-5
NEFF_ZONE = 1e-4


def _angle_gap(a, b):
    d = torch.remainder(a - b + math.pi, 2.0 * math.pi) - math.pi
    return d.abs()


def _pose_gap(a, b):
    """Largest gap of [..., >=3] poses: x, y and the wrapped heading."""
    a, b = a.double(), b.double()
    gaps = torch.cat([(a[..., :2] - b[..., :2]).abs().reshape(-1),
                      _angle_gap(a[..., 2], b[..., 2]).reshape(-1)])
    return _finite_max(gaps)


def _finite_max(x):
    if x.numel() == 0:
        return 0.0
    if not bool(torch.isfinite(x).all()):
        return math.inf
    return float(x.max())


def map_differing(prog_map, ref_map, idx) -> float:
    """Share of particles j whose map differs from ref_map[idx[j]]."""
    bad = torch.zeros(idx.shape[0], dtype=torch.bool, device=idx.device)
    for p, r in zip(prog_map, ref_map):
        r = r[idx]
        off = (p - r).abs() > ATOL + RTOL * r.abs()
        bad |= (off | ~torch.isfinite(p)).any(-1)
    return float(bad.double().mean())


def resample_gap(cum, u, idx, lw_ref) -> float:
    """Largest gap, in units of 1 / P, of the picks idx against the
    reference's float64 cumulative weights cum for the uniforms u."""
    P = cum.shape[0]
    r = (torch.arange(P, dtype=torch.float64, device=cum.device)
         + u.double()) / P
    lo = torch.cat([cum.new_zeros(1), cum[:-1]])[idx]
    hi = cum[idx]
    gap = torch.clamp(torch.maximum(lo - r, r - hi), min=0.0)
    # past the end the stratified rule takes the heaviest particle
    past = torch.clamp(cum[-1] - r, min=0.0)
    gap = torch.where(idx == torch.argmax(lw_ref), torch.minimum(gap, past),
                      gap)
    return _finite_max(gap) * P


def judge_step(inp, out, c, dt) -> dict:
    """The six numbers of one step. inp: dict(pose, lw, map (6 channels),
    control, zr, zb, count, do_predict, normals [P, 2], uniforms [P]); out:
    dict(pose, lw, map, idx, expected_pose, neff, resampled), all global
    and on one device."""
    P = inp["pose"].shape[0]
    parts = R.particle_stage(inp["pose"], inp["lw"], R.Map(*inp["map"]),
                             inp["control"], inp["zr"], inp["zb"],
                             inp["count"], inp["do_predict"],
                             inp["normals"], c, dt,
                             block=R.block_for(c, P))
    g = R.global_stage(parts.lw, parts.pose, c, updated=inp["count"] > 0)
    thr = c["resample_threshold"]
    fire = g.fire
    if inp["count"] > 0 and abs(g.neff - thr) <= NEFF_ZONE * thr:
        fire = bool(out["resampled"])
    idx = out["idx"].long()
    in_range = bool(((idx >= 0) & (idx < P)).all())
    idx = torch.clamp(idx, 0, P - 1)
    ident = torch.arange(P, device=idx.device)
    if fire:
        rs_gap = resample_gap(g.cum, inp["uniforms"], idx, g.lw)
        lw_want = torch.full_like(g.lw, -math.log(float(P)))
    else:
        rs_gap = 0.0 if bool((idx == ident).all()) else float(P)
        lw_want = g.lw
    if not in_range:
        rs_gap = math.inf
    neff_prog = float(out["neff"])
    return dict(
        pose_gap=_pose_gap(out["pose"], parts.pose[idx]),
        map_differing=map_differing(out["map"], parts.map, idx),
        weight_gap=_finite_max((out["lw"].double() - lw_want.double())
                               .abs()),
        neff_gap=(abs(neff_prog - g.neff) / g.neff
                  if math.isfinite(neff_prog) else math.inf),
        resample_gap=rs_gap,
        pose_estimate_gap=_pose_gap(out["expected_pose"][None],
                                    g.expected_pose[None]))


def widest(per_step) -> dict:
    """Each number's largest value over the steps compared."""
    return {k: max(s[k] for s in per_step) for k in NAMES}


def verdict(numbers: dict, limits: dict):
    """(correct, checks): every number at or under its limit; checks maps
    each name to its value and limit, in NAMES order."""
    checks = {k: dict(value=numbers[k], limit=limits[k]) for k in NAMES}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in checks.values())
    return ok, checks
