"""portbench: the benchmark of redmax_tpu_torch on an NVIDIA H100 (see README.md)."""
