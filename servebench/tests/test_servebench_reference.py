"""The frozen float32 reference against the program's plain CPU path, at a
tiny size, on the same weights (the test may import the program; the
reference may not)."""
from __future__ import annotations

import copy

import pytest
import torch

from conftest import TINY_CONFIG
import families
from harness.weights import make_params
from reference import model as ref, precision

FAMILIES = {
    # Qwen2: q/k/v bias, tied embeddings
    "qwen2": dict(attention_bias=True, tie_word_embeddings=True,
                  init={"embed_std": 0.125, "norm_std": 0.1,
                        "bias_std": 0.1}),
    # Yi / Llama: no bias, untied embeddings
    "yi": dict(attention_bias=False, tie_word_embeddings=False,
               rope_theta=5e6),
}


def config(family):
    c = copy.deepcopy(TINY_CONFIG)
    c.update(FAMILIES[family])
    return c


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reference_matches_the_programs_plain_forward(family):
    from repro_torch.models import transformer as tf
    c = config(family)
    params, _ = make_params(c, 3, "cpu")
    tokens = torch.randint(1, c["vocab_size"], (37,),
                           generator=torch.Generator().manual_seed(0))
    want, _, _ = tf.forward(params, families.load(c).port_config(c),
                             tokens[None].long())
    got = ref.logits(params, c, [(tokens.int(), 0)])[0]
    assert got.shape == want[0].shape
    scale = want.abs().max()
    assert (got - want[0]).abs().max() <= 1e-4 * scale


def test_tied_embeddings_share_storage():
    params, flat = make_params(config("qwen2"), 1, "cpu")
    assert params["lm_head"].data_ptr() == params["embed"].data_ptr()
    assert params["lm_head"].shape == params["embed"].t().shape


def test_weights_redrawn_in_place_keep_their_views():
    c = config("yi")
    params, flat = make_params(c, 1, "cpu")
    w = params["layers"][1]["mlp"]["w_down"]
    before = w.clone()
    again, _ = make_params(c, 2, "cpu", flat=flat)
    assert w.data_ptr() == again["layers"][1]["mlp"]["w_down"].data_ptr()
    assert not torch.equal(before, w)
    same, _ = make_params(c, 1, "cpu")
    assert torch.equal(before, same["layers"][1]["mlp"]["w_down"])


def test_fp8_products_are_coarser_than_float32():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 256, generator=g)
    b = torch.randn(256, 32, generator=g)
    exact = precision.exact_mm(a, b)
    low = precision.fp8_mm(a, b)
    rel = ((low - exact).norm() / exact.norm()).item()
    assert 1e-3 < rel < 0.1
