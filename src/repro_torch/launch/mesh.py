"""Production mesh builders.

Functions, not module constants: importing this module touches no
distributed state.  Both sit over the default process group, which the
caller has initialised (``dryrun.main`` starts a fake one of the mesh's
world size on the host; ``chip_smoke.py`` an NCCL one of world 1).
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16x16 = 256 cards per pod; the multi-pod mesh adds a leading
    'pod' axis (2 pods = 512 cards)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_local_mesh(model: int = 1, device: str = "cuda"):
    """(world // model, model) over ("data", "model"): whatever ranks the
    process group holds."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"model axis {model} does not divide world {world}")
    return init_device_mesh(device, (world // model, model),
                            mesh_dim_names=("data", "model"))
