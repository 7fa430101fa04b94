"""PyTorch/CUDA port of co_zkvms_tpu on one NVIDIA H100: single-party
Spartan over PST13 (zk and the succinct DFS round included) and co-Spartan
over Rep3 shares, with hand-written CUDA kernels for the field, G1,
MSM-bucket and sumcheck-round work. The JAX package ``co_zkvms_tpu`` stays
the frozen reference; this package imports nothing of it and nothing of
JAX."""
