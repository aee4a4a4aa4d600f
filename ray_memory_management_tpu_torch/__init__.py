"""PyTorch/CUDA port of ray_memory_management_tpu, slice by slice.

The JAX package stays the reference; this package mirrors its module
names (``ops.flash_attention``, ``models.gpt``, ``serve.llm``, ...) and
runs on an NVIDIA Hopper card, with the JAX package's Pallas kernels
rewritten by hand in CUDA C++ under ``csrc/``. Importing the package
imports no submodule and starts nothing; entry points run on the card
unless the caller passes ``device="cpu"``.
"""
