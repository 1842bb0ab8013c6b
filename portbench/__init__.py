"""The benchmark of ``tpu_dra_driver_torch`` on one NVIDIA H100: cells of
StarCoder2 training, serving and generation, driven by data files. See
``README.md``."""
