"""comat_tpu_torch: the PyTorch and CUDA port of comat_tpu.

Module names follow the JAX package's, so each counterpart is easy to
find. The package imports torch and never jax or comat_tpu; its entry
points run on CUDA unless the caller asks for the CPU.
"""
