"""The accuracy evidence entry points: the JAX package's evidence scripts
(``scripts/round3_evidence.py``, ``mixed_evidence.py``,
``disparity_evidence.py``, ``fastslam_evidence.py``, ``cphd_dwell.py``,
``ospa_latency.py``) run on the port, one module each:

    python3 -m phdslam_tpu_torch.evidence.<name> [phase] [flags]

Each keeps its script's scenarios, seeds, arms, run counts, steps and
particle counts, and writes its script's JSON keys into
``results/port_evidence.json`` (``common.py``). They run on the GPU unless
given ``--device cpu``; without CUDA they raise."""
