"""Roofline analysis of the dry-run's traced records — the reference's
``analysis/roofline.py`` with the H100's constants and torch's
collectives.

Three terms, all in seconds, per device (the dry-run traces one rank, so
its FLOPs, live bytes and collective bytes are per device):

  compute    = FLOPs / peak_FLOP/s                   (989 TF bf16 dense)
  memory     = peak live bytes / HBM_bw              (3.35 TB/s)
  collective = output bytes of every collective / link bandwidth:
               NVLink (450 GB/s each way) for a mesh that fits one 8-card
               host, else the network between hosts (50 GB/s a card)

Also reports MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) per device
and the usefulness ratio MODEL_FLOPS / counted FLOPs.

:class:`CollectiveCounter` takes the place of the reference's HLO text
parser: a dispatch mode that adds up the output bytes of every
``_c10d_functional`` collective DTensor (or the caller) issues on the
traced rank.
"""
from __future__ import annotations

import collections
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.hw import H100

#: cards one NVLink host joins all to all (an HGX H100 board)
NVLINK_HOST_CARDS = 8

#: ops of ``_c10d_functional`` that complete or wrap a collective's result
#: (not counted)
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


def _out_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_out_bytes(o) for o in out)
    return 0


class LocalOpMode(TorchDispatchMode):
    """A dispatch mode that sees the traced rank's local ops: an op on
    DTensors is handed on to DTensor (``NotImplemented``), which runs it
    on the local shards, through this mode again; the redistributions it
    issues come through too."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        for t in types:
            if issubclass(t, DTensor):
                return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func is not _PRIM_DEVICE:        # a ``.device`` read
            self.on_op(func, args, kwargs or {}, out)
        return out

    def on_op(self, func, args, kwargs, out):
        raise NotImplementedError


_PRIM_DEVICE = torch.ops.prim.device.default


def _model_site() -> str:
    """``file:line function`` of the innermost frame of the port's model
    or training code on the stack (the site a collective serves), else
    ``other``."""
    import traceback
    for fr in reversed(traceback.extract_stack()):
        if "/repro_torch/models/" in fr.filename \
                or "/repro_torch/training/" in fr.filename:
            return f"{fr.filename.rsplit('/', 1)[-1]}:{fr.lineno} {fr.name}"
    return "other"


class CollectiveCounter(LocalOpMode):
    """Output bytes of every collective, counted once where it is issued
    and not again at its ``wait_tensor``: the reference's rule (the
    output shape's bytes, ``-done`` not counted) on torch's ops.
    ``counts`` and ``bytes_by_op`` hold the same by op name
    (``all_gather_into_tensor``, ``all_reduce``, ``reduce_scatter_tensor``,
    ``all_to_all_single``, ...).  With ``sites``, ``bytes_by_site`` holds
    them by op and the model code's line that issued them
    (:func:`_model_site`; a stack walk an op, for a diagnosis only)."""

    def __init__(self, sites: bool = False):
        super().__init__()
        self.total_bytes = 0
        self.counts = collections.Counter()
        self.bytes_by_op = collections.Counter()
        self.bytes_by_site = collections.Counter() if sites else None

    def on_op(self, func, args, kwargs, out):
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_dtensor" and name == "shard_dim_alltoall":
            name = "all_to_all_single"
        elif ns != "_c10d_functional" or name in _NOT_COLLECTIVES:
            return
        n = _out_bytes(out)
        self.total_bytes += n
        self.counts[name] += 1
        self.bytes_by_op[name] += n
        if self.bytes_by_site is not None:
            self.bytes_by_site[f"{name} {_model_site()}"] += n


def model_flops_per_device(arch: str, shape: str, n_devices: int) -> float:
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import SHAPES
    cfg = get_config(arch)
    info = SHAPES[shape]
    n = cfg.active_param_count()
    if info["kind"] == "train":
        tokens = info["seq"] * info["batch"]
        return 6.0 * n * tokens / n_devices
    if info["kind"] == "prefill":
        tokens = info["seq"] * info["batch"]
        return 2.0 * n * tokens / n_devices
    tokens = info["batch"]          # decode: one token per sequence
    return 2.0 * n * tokens / n_devices


def collective_link(n_devices: int):
    """(name, bytes/s a card) of the link a mesh of ``n_devices`` cards
    moves its collectives over."""
    hw = H100
    if n_devices <= NVLINK_HOST_CARDS:
        return "nvlink", hw.ici_bw * hw.ici_links
    return "dcn", hw.dcn_bw


def roofline_report(rec: Dict) -> Dict:
    """Three terms (seconds, per device):
      compute    — traced FLOPs (FlopCounterMode's products and
                   attention) / peak
      memory     — working-set stream: peak live bytes of the traced
                   rank / HBM bw (the working set streamed once, as the
                   reference models it)
      collective — collective output bytes / the link's bandwidth
                   (``collective_link``)
    """
    hw = H100
    link, link_bw = collective_link(rec["n_devices"])
    compute_s = rec["flops_per_device"] / hw.peak_flops
    memory_s = rec["peak_bytes_per_device"] / hw.hbm_bw
    coll_s = rec["collective_bytes_per_device"] / link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    mflops = model_flops_per_device(rec["arch"], rec["shape"],
                                    rec["n_devices"])
    return {
        **{k: float(f"{v:.6g}") for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "collective_link": link,
        "model_flops_per_device": float(f"{mflops:.6g}"),
        "useful_flops_ratio": float(
            f"{mflops / max(rec['flops_per_device'], 1):.4g}"),
        "fits_hbm": rec["peak_bytes_per_device"] <= hw.hbm_bytes,
    }
