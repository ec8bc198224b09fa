"""The plain references of the served model families, one module a
family's reference (``model.py``: the ``decoder`` family's), and the
precision of their products (``precision.py``): float32 PyTorch, no
kernels, no cache, no batching.  They import nothing of the program and
nothing of the harness."""
