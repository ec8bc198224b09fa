"""Shared pieces of the harness's CPU tests: the import paths a run sets
up, and a tiny cell that runs on the CPU through the same code."""
from __future__ import annotations

import copy
import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the llava configuration's layout at a size a CPU test holds (the
#: serving estimator of smollm-135m paces it: a few ms an iteration)
TINY_CONFIG = {
    "name": "tiny", "source": "test", "port_arch": "smollm-135m",
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 256,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "attention_bias": True,
    "tie_word_embeddings": False, "torch_dtype": "float32",
    "executor": {"n_p": 1, "n_d": 1, "s_p": 64, "s_d": 32, "horizon": 8,
                 "n_slots": 32, "max_seq": 256, "hbm_blocks": 96,
                 "block_size": 16},
    "init": {"embed_std": 1.0, "norm_std": 0.1, "bias_std": 0.1},
    "trace": {"start_share": 0.4, "seconds": 0.5},
    "check": {"gap_limit": 1e-3},
}

TINY_TRAFFIC = {
    "arrivals": {"process": "poisson", "rate_per_s": 16.0},
    "prompt_tokens": {"mu": 3.6, "sigma": 0.5, "lo": 16, "hi": 96},
    "output_tokens": {"mu": 2.3, "sigma": 0.5, "lo": 4, "hi": 24},
    "limits": {"ttft_s": 1.0, "tpot_s": 0.2},
    "after_window": "drain",
    "warmup": {"requests": 4, "max_output": 4},
    "check": {"served_tokens": 60, "max_tokens": 4000},
}


def tiny_cell(**traffic):
    from harness.spec import Cell
    mix = copy.deepcopy(TINY_TRAFFIC)
    mix.update(traffic)
    return Cell("tiny.chat", 1, copy.deepcopy(TINY_CONFIG), mix, "tiny",
                [{"name": n, "unit": "s"} for n in
                 ("ttft_p90_s", "tpot_p90_s", "setup_s")], [])


@pytest.fixture
def cell():
    return tiny_cell()


def write_json(path, obj):
    path.write_text(json.dumps(obj))
