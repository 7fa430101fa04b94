"""PyTorch/CUDA port of co_zkvms_tpu: single-party Spartan over PST13 on one
NVIDIA H100, with hand-written CUDA kernels for the field, G1 and MSM-bucket
work. The JAX package ``co_zkvms_tpu`` stays the frozen reference; this
package imports nothing of it and nothing of JAX."""
