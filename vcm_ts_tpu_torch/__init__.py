"""PyTorch/CUDA port of the vcm_ts_tpu learned video codec.

A package of its own beside the JAX package: it imports neither JAX nor
anything of `vcm_ts_tpu`, and keeps its own copies of the host-side entropy
coder and container code. Entry points run on the GPU (`device="cuda"`)
unless the caller passes `device="cpu"`; they never fall back on their own.
"""
