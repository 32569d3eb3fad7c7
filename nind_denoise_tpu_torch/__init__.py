"""PyTorch/CUDA port of nind_denoise_tpu for NVIDIA Hopper GPUs.

The JAX package ``nind_denoise_tpu`` is the reference this package is held
against (tests/test_torch_*.py). Nothing here imports jax or the JAX
package; the host-side modules it needs are copied, not imported.
"""
