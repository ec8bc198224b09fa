"""PyTorch/CUDA port of the TaiChi serving system.

Mirrors the sub-packages of the JAX reference package ``repro`` module
for module, imports ``torch`` and numpy only, and runs on the card unless
the caller passes ``device="cpu"``.

The package itself imports nothing: the front end's tokenizer workers
import ``repro_torch.frontend`` and must start without torch.  The
setting the card's float32 products need lives in
``repro_torch.models.common``, which every model path imports.
"""
