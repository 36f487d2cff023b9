"""crfr_torch: the PyTorch/CUDA port of crfr (cross-resolution face
recognition) for NVIDIA Hopper.

The JAX package ``crfr`` is the reference; this package mirrors its module
names. Its entry points run on the CUDA device unless the caller passes
``device="cpu"``, and raise when asked for CUDA on a machine without it.
It imports neither JAX nor anything of ``crfr``.
"""
