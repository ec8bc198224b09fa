"""The port's train step, checkpoint and launcher
(``training/train.{make_train_step,make_eval_step}``,
``training/checkpoint.py``, ``launch/train.py``) on the CPU: a step and
its evaluation, a checkpoint round trip with the optimizer state, and
the launcher's CPU run."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.models import transformer as tf
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import (AdamWConfig, init_opt_state,
                                            tree_leaves)
from repro_torch.training.train import (make_eval_step, make_train_step,
                                        synthetic_lm_batches)

from test_torch_training import _batch


# ---------------------------------------------------------------------------
# the step, the checkpoint and the launcher
# ---------------------------------------------------------------------------

def test_train_step_and_eval_step():
    cfg = reduced_config("whisper-base")
    _, bt = _batch(cfg, 111)
    params = tf.init_params(5, cfg, device="cpu")
    before = params["layers"][-1]["xattn"]["wq"].clone()
    loss0 = float(make_eval_step(cfg)(params, bt))
    step = make_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=0))
    state = init_opt_state(params)
    params, state, m = step(params, state, bt)
    assert float(m["loss"]) == pytest.approx(loss0, rel=1e-6)
    assert int(m["step"]) == 1 and np.isfinite(float(m["grad_norm"]))
    assert not torch.equal(before, params["layers"][-1]["xattn"]["wq"])
    assert float(make_eval_step(cfg)(params, bt)) < loss0


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-3b"])
def test_checkpoint_roundtrip_with_opt_state(arch, tmp_path):
    """Parameters (bf16 for qwen2.5-3b: through float32 on the host) and
    optimizer state come back bit-equal, typed as the template; a step
    from the loaded state equals a step from the saved one."""
    cfg = reduced_config(arch)
    if arch == "qwen2.5-3b":
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = tf.init_params(0, cfg, device="cpu")
    opt_cfg = AdamWConfig(warmup_steps=1)
    step = make_train_step(cfg, opt_cfg)
    batch = next(synthetic_lm_batches(cfg, 2, 16, device="cpu"))
    state = init_opt_state(params)
    params, state, _ = step(params, state, batch)
    path = os.path.join(tmp_path, "c.npz")
    save_checkpoint(path, params, state, meta={"arch": cfg.name},
                    cfg=cfg)
    template = tf.init_params(1, cfg, device="cpu")
    p2, s2 = load_checkpoint(path, template, init_opt_state(template))
    for a, b in zip(tree_leaves(params), tree_leaves(p2)):
        assert b.dtype == a.dtype == cfg.param_dtype
        assert torch.equal(a.detach(), b)
    assert int(s2.step) == int(state.step) == 1
    for a, b in zip(tree_leaves((state.m, state.v)),
                    tree_leaves((s2.m, s2.v))):
        assert torch.equal(a, b)
    with open(path + ".meta.json") as f:
        assert json.load(f) == {"arch": cfg.name}
    _, _, m1 = step(params, state, batch)
    _, _, m2 = step(p2, s2, batch)
    assert float(m1["loss"]) == float(m2["loss"])


def test_launch_train_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    path = os.path.join(tmp_path, "ck.npz")
    launch_train.main(["--arch", "smollm-135m", "--steps", "3", "--batch",
                       "2", "--seq", "16", "--device", "cpu", "--ckpt",
                       path])
    out = capsys.readouterr().out
    hist = json.loads(out[:out.index("]") + 1])
    assert [h["step"] for h in hist] == [0, 2]
    assert "checkpoint saved to" in out and os.path.exists(path)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            launch_train.main(["--steps", "1"])