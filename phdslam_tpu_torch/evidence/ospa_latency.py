"""Latency and accuracy of the in-loop OSPA on the port
(``scripts/ospa_latency.py``): ``ops/ospa.py::ospa_torch`` at set sizes
16, 64 and 256.

    python3 -m phdslam_tpu_torch.evidence.ospa_latency [--device cuda|cpu]

For each size, 8 random pairs of padded sets (seed s: default_rng(s), the
live counts between n/2 and n, points N(0, 8)), p = 1, c = 5: the largest
|ospa_torch - ospa_np| over the pairs, and the mean time of 20
back-to-back calls on the first pair after one warm call, the last result
copied to the host -> "ospa_latency" (backend, rows, note).
--smoke: sizes 16 and 64, 2 pairs, nothing written."""

from __future__ import annotations

import sys
import time

import numpy as np

from phdslam_tpu_torch.evidence import common as C

SIZES, SEEDS, TIMED, P, CUT = (16, 64, 256), 8, 20, 1.0, 5.0
NOTE = ("ospa_torch latency (mean of 20 back-to-back calls, the last "
        "result copied to the host) and worst |ospa_torch - ospa_np| over "
        "8 random set pairs, p=1 c=5")


def pair(n_pad: int, seed: int):
    """(x, x_valid, y, y_valid, m_x, m_y): the script's random pair."""
    r = np.random.default_rng(seed)
    m_x = int(r.integers(n_pad // 2, n_pad + 1))
    m_y = int(r.integers(n_pad // 2, n_pad + 1))
    x = r.normal(0, 8, (n_pad, 2)).astype(np.float32)
    y = r.normal(0, 8, (n_pad, 2)).astype(np.float32)
    return x, np.arange(n_pad) < m_x, y, np.arange(n_pad) < m_y, m_x, m_y


def probe_row(n_pad, lat_ms, gaps, n_seeds) -> dict:
    return dict(n=n_pad, ms=round(lat_ms, 3), max_gap=round(max(gaps), 5),
                seeds=n_seeds)


def probe(n_pad: int, dev, n_seeds: int = SEEDS, n_time: int = TIMED):
    import torch

    from phdslam_tpu_torch.ops import ospa as O
    gaps, lat_ms = [], None
    for seed in range(n_seeds):
        x, xv, y, yv, m_x, m_y = pair(n_pad, seed)
        args = tuple(torch.as_tensor(a, device=dev) for a in (x, xv, y, yv))
        e, _, _ = O.ospa_torch(*args, p=P, c=CUT)
        ne = O.ospa_np(x[:m_x], y[:m_y], p=1, c=5)[0]
        gaps.append(abs(float(e) - ne))
        if seed == 0:
            # the timed window on the first pair, after the warm call above
            t0 = time.perf_counter()
            for _ in range(n_time):
                e, _, _ = O.ospa_torch(*args, p=P, c=CUT)
            float(e)                       # waits for the device
            lat_ms = (time.perf_counter() - t0) * 1e3 / n_time
    return probe_row(n_pad, lat_ms, gaps, n_seeds)


def main(argv=None) -> dict:
    ap = C.parser(__doc__.split("\n")[0])
    opts = ap.parse_args(argv)
    dev = C.resolve_device(opts.device)
    sizes, seeds = ((16, 64), 2) if opts.smoke else (SIZES, SEEDS)
    print("backend:", dev.type)
    rows = [probe(n, dev, seeds) for n in sizes]
    for r in rows:
        print(r)
    out = dict(backend=dev.type, rows=rows, note=NOTE)
    fields = C.device_fields(dev)
    if opts.smoke:
        return dict(ospa_latency=dict(out, **fields))
    return C.merge_json(dict(ospa_latency=out), opts.out, fields)


if __name__ == "__main__":
    main(sys.argv[1:])
