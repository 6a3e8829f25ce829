"""The benchmark of phdslam_tpu_torch: see README.md."""
