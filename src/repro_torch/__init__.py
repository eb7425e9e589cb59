"""Space-Control on PyTorch and CUDA: the port of the JAX package
``repro`` to one NVIDIA H100.

It mirrors ``repro``'s module names and is held against it bit for bit by
the ``tests/test_torch_*.py`` parity tests; it never imports JAX or
``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions.
"""
