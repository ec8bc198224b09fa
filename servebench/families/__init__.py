"""One module per model family: everything of the benchmark that knows a
model's layout.  A configuration file names its family under the key
``family`` (``decoder`` where it names none), and ``load`` finds the
module ``<family>.py`` on ``PATH``; so a configuration of another
architecture joins the benchmark as new files, and no other file of the
harness names a leaf, a layer or a model FLOP formula.

A family module defines:

* ``port_config(config)``: the program's ``ModelConfig`` of the file;
* ``leaf_specs(config)``: ``(path, shape, group)`` of every leaf to draw,
  in the served layout, each group one run of the flat buffer
  (``harness/weights.py``); ``group_std(config, group)``: the group's
  standard deviation; ``tree(leaves, config)``: the params the program
  and the reference take, from the drawn views (``{path: tensor}``);
* ``logits(params, config, seqs, mm)``: the family's plain float32
  reference (in ``servebench/reference/``) over ``seqs`` of ``(tokens,
  first, inputs)``, each product through ``mm`` (``reference/
  precision.py``: exact, or the float8 control);
* ``shape(config, block_size)``: what kernels 1 and 2 count, a
  ``harness.count.Shape``; ``model_flops(shape, rows, extras)``: the
  model FLOPs of rows of ``(start, valid, produces a token)`` plus the
  per-request work that is no token, for the requests whose prefill
  starts among them (``extras``: their ``inputs``);
* ``inputs``: None where a request carries its prompt ids alone, else a
  function ``(arrival, rng) -> dict`` of what it carries beyond them
  (and the prompt positions that takes), drawn from its own stream
  (``harness/traffic.py``); ``request_kwargs(arrival)``: what the
  program's ``Request`` takes beyond its prompt.
"""
from __future__ import annotations

import importlib.util
import os
import re
import sys

#: the family of a configuration file without a ``family`` key
DEFAULT = "decoder"

#: directories searched, in order, for ``<family>.py``
PATH = [os.path.dirname(os.path.abspath(__file__))]

#: what every family module defines
HOOKS = ("port_config", "leaf_specs", "group_std", "tree", "logits",
         "shape", "model_flops", "inputs", "request_kwargs")


def name(config: dict) -> str:
    fam = config.get("family", DEFAULT)
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", fam):
        raise ValueError(f"not a family module's name: {fam!r}")
    return fam


def load(config: dict):
    """The family module of a configuration file (loaded once a path)."""
    fam = name(config)
    paths = [os.path.join(d, f"{fam}.py") for d in PATH]
    found = [p for p in paths if os.path.exists(p)]
    if not found:
        raise KeyError(f"no family {fam!r}: none of {paths}")
    path = os.path.abspath(found[0])
    key = f"families.{fam}"
    mod = sys.modules.get(key)
    if mod is None or os.path.abspath(mod.__file__) != path:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    missing = [h for h in HOOKS if not hasattr(mod, h)]
    if missing:
        raise AttributeError(f"family {fam!r} ({path}) lacks {missing}")
    return mod
