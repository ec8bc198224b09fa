"""Hand-written Hopper kernels of the port.

Each kernel lives in ``csrc/`` as CUDA C++ and is reached through an
``ops.py`` wrapper that keeps the name and signature of the reference's
wrapper.  A wrapper launches its kernel for a CUDA tensor (or raises) and
takes the plain PyTorch version beside it only for a tensor that lies on
the CPU.  Nothing is compiled when this package is imported: the shared
library is built by ``build.load_library`` at the first launch.
"""
