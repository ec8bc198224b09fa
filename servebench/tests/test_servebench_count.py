"""The counts of operations and bytes against hand counts at the served
shapes, and the table of peaks."""
from __future__ import annotations

import json
import os

import pytest

from conftest import BENCH
from harness import count

LLAVA = count.Shape(layers=60, d_model=7168, heads=56, kv_heads=8,
                    head_dim=128, d_ff=20480, vocab=64000)
QWEN = count.Shape(layers=36, d_model=2048, heads=16, kv_heads=2,
                   head_dim=128, d_ff=11008, vocab=151936)


def test_decode_call_by_hand():
    # one llava row over 1000 keys: K and V, 1000 x 8 heads x 128 x 2 B
    # each; q and out 56 x 128 x 2 B each; 63 table entries of 4 B
    f, b = count.decode_call(LLAVA, [1000])
    assert f == 4 * 56 * 128 * 1000
    assert b == 2 * 1000 * 8 * 128 * 2 + 2 * 56 * 128 * 2 + 4 * 63
    # rows add; an empty call is free
    f2, b2 = count.decode_call(LLAVA, [1000, 1000])
    assert (f2, b2) == (2 * f, 2 * b)
    assert count.decode_call(LLAVA, []) == (0.0, 0.0)


def test_prefill_call_by_hand():
    # a qwen chunk of 256 tokens after 768: keys 1024; the causal
    # triangle 256 x 768 + 256 x 257 / 2 query-key pairs
    f, b = count.prefill_call(QWEN, [(768, 256)])
    assert f == 4 * 16 * 128 * (256 * 768 + 256 * 257 / 2)
    assert b == (2 * 1024 * 2 * 128 * 2 + 2 * 256 * 16 * 128 * 2
                 + 4 * 64)
    # a decode row riding along is a chunk of one; padding rows count 0
    assert count.prefill_call(QWEN, [(99, 1)]) == count.decode_call(
        QWEN, [100])
    assert count.prefill_call(QWEN, [(5, 0)]) == (0.0, 0.0)


def test_model_flops_by_hand():
    # qwen2.5-3b: 36 layers of 2048 x 128 x (16 + 4) + 2048 x 2048 + 3 x
    # 2048 x 11008 parameters in matrices
    per_layer = 2048 * 128 * 20 + 2048 * 2048 + 3 * 2048 * 11008
    assert QWEN.layer_matrix_params == per_layer
    # one decode token at position 99 that is produced
    want = (2 * per_layer * 36 + 4 * 16 * 128 * 100 * 36
            + 2 * 2048 * 151936)
    assert count.model_tokens(QWEN, [(99, 1, True)]) == want
    # a prefill chunk that completes nothing has no lm_head row
    chunk = count.model_tokens(QWEN, [(0, 4, False)])
    assert chunk == 4 * 2 * per_layer * 36 + 4 * 16 * 128 * 36 * 10


def test_llava_decode_step_is_bound_by_its_weights():
    # a 16-row llava decode step at 1000 keys: weights 2 x 34.4 G
    # parameters dominate, ~20.5 ms at 3.35 TB/s
    params = (LLAVA.layer_matrix_params * LLAVA.layers
              + 2 * LLAVA.d_model * LLAVA.vocab)
    assert abs(2 * params / 3.35e12 - 0.0205) < 0.0005


def test_least_seconds_picks_the_binding_peak():
    name = "NVIDIA H100 80GB HBM3"
    t, which = count.least_seconds(989e12, 1.0, name)
    assert (t, which) == (1.0, "flops")
    t, which = count.least_seconds(1.0, 3.35e12, name)
    assert (t, which) == (1.0, "bytes")
    assert count.peaks(name)["power_limit_w"] == 700.0
    with pytest.raises(KeyError):
        count.peaks("some other card")


def test_configured_shapes_are_the_published_ones():
    for name, shape in (("llava-next-34b", LLAVA), ("qwen2.5-3b", QWEN)):
        path = os.path.join(BENCH, "configs", f"{name}.json")
        if not os.path.exists(path):
            continue
        c = json.load(open(path))
        assert (c["num_hidden_layers"], c["hidden_size"],
                c["num_attention_heads"], c["num_key_value_heads"],
                c["intermediate_size"], c["vocab_size"]) == (
            shape.layers, shape.d_model, shape.heads, shape.kv_heads,
            shape.d_ff, shape.vocab)
