"""The benchmark of chan_vese_tpu_torch: see run.py."""
