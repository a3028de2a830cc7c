"""portbench: the benchmark of benlsip_tpu_torch on one CUDA card."""
