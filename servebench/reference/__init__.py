"""The plain reference of the served models (``model.py``): float32
PyTorch, no kernels, no cache, no batching.  It imports nothing of the
program and nothing of the harness."""
