"""The benchmark of eqxvision_tpu_torch on the H100: see README.md."""
