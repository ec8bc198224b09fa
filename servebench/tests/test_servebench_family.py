"""The family seam (``servebench/families/``): the ``decoder`` family draws,
computes and counts exactly what the harness did before it had families
(golden values of that harness, recorded at float32 on the CPU with this
torch, one thread), and a second family joins the benchmark as one new
module on the family search path, with no edit to any other harness
file."""
from __future__ import annotations

import copy
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, TINY_CONFIG, tiny_cell
import families
from harness import count, readout
from harness.serve import Dispatch
from harness.traffic import Traffic, rng_for
from harness.weights import make_params
from reference import precision

sys.path.insert(0, os.path.join(BENCH, "tools"))

import run  # noqa: E402

VARIANTS = {
    "tiny": {},
    "qwen2": dict(attention_bias=True, tie_word_embeddings=True,
                  init={"embed_std": 0.125, "norm_std": 0.1,
                        "bias_std": 0.1}),
    "yi": dict(attention_bias=False, tie_word_embeddings=False,
               rope_theta=5e6),
}

#: sha256 of the flat weight buffer, a variant and seed
WEIGHTS = {
    ("tiny", 1): "2c478fd12da62d9c1277247a00f0c3d5c8552d7e5e8ebfb936ae0b7769114c58",
    ("tiny", 2): "427e0a4fd6cfb2e885fbb0eb2184d9f8d43ffa3d36b7cf213dbf8b296f9c65b4",
    ("qwen2", 1): "5cc4adf9d74676c1d69d0028c2dee98ea95a933c1984892ccc131da84000eae8",
    ("qwen2", 2): "99379e7698ac4c0a0861ce6f9e3f3849f37ff9342dbf8a5dc5610db490e2c8bf",
    ("yi", 1): "f5cb3e87957e0c801a48bf1f7714e8bb2fc52da2d0fad73d39f292e7a26472b9",
    ("yi", 2): "27ac0850c04a99a8d6253134a3dcadd27d9388b28a683006e8b583c582be396b",
}

#: sha256 of the reference's logits of ``SEQS`` (seed 3's weights), with
#: exact products and with the float8 control's
LOGITS = {
    "tiny": ["407346c3883ab4e7208b06eff3ed928a8b43fa64344d77849bf1f756c07c1c0a",
             "36b0af5dd9e100f8db18da08904ba6adbaedecf0cee46713008d3a6ec42ff1c4"],
    "qwen2": ["174d1f0ae53d42b1db77ad75472faa7d283d46561f7545da561f124e68a69054",
              "cdde6f710a1b9d926aeb017346749ede2446bd756132823167981dc8c64ef4be"],
    "yi": ["9f04ae0df656f521af470c6e56f3af78c7bd8a69312baa9c8f88a5801a70131d",
           "d452a95347f9e3953cc382dca4942086d67365916b8354d80eab32e79d076bff"],
}
FP8_LOGITS = {
    "tiny": ["8fa252d02b1ae5b6e9d23af1f94230d0b2452062e83c388340552d2b2b61b7c7",
             "468a7dd07e00e455ff2d5d56fecc6702b3bdf36bf1431982f6f5ae32ff4e8c6e"],
    "qwen2": ["b4da2f922f15c583fdb8e0f1b1384d335cea265e1ac29c2b720c779be4e4f388",
              "0ac1b8208b7e38b41d5b994fde1c0ddedb514102dea54ea5005a87a80f079a39"],
    "yi": ["8a0adebc4d6d1bfffc0f4e85f93cce5c1980a3b758d36808d8d237924a11d61c",
           "f822ce8004f1d37644478c52bd20c7a642e3d8f7c5b6285e30818244e09aa286"],
}

LLAVA = count.Shape(layers=60, d_model=7168, heads=56, kv_heads=8,
                    head_dim=128, d_ff=20480, vocab=64000)
QWEN = count.Shape(layers=36, d_model=2048, heads=16, kv_heads=2,
                   head_dim=128, d_ff=11008, vocab=151936)
ROWS = [(0, 1024, False), (1024, 77, True), (99, 1, True), (4000, 1, True),
        (5, 0, True), (300, 256, True)]


def config(variant):
    c = copy.deepcopy(TINY_CONFIG)
    c.update(VARIANTS[variant])
    return c


def sha(t) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant,seed", sorted(WEIGHTS))
def test_the_decoder_family_draws_the_same_weights(variant, seed):
    _, flat = make_params(config(variant), seed, "cpu")
    assert sha(flat) == WEIGHTS[variant, seed]


@pytest.mark.parametrize("variant", sorted(LOGITS))
def test_the_decoder_reference_gives_the_same_logits(variant, one_thread):
    c = config(variant)
    params, _ = make_params(c, 3, "cpu")
    g = torch.Generator().manual_seed(0)
    seqs = [(torch.randint(1, 256, (37,), generator=g).int(), 0, {}),
            (torch.randint(1, 256, (20,), generator=g).int(), 5, {})]
    family = families.load(c)
    assert family is families.load(c)
    assert [sha(x) for x in family.logits(params, c, seqs)] \
        == LOGITS[variant]
    assert [sha(x) for x in family.logits(params, c, seqs,
                                          mm=precision.fp8_mm)] \
        == FP8_LOGITS[variant]


def test_the_decoder_counts_are_the_same():
    dec = families.load(TINY_CONFIG)
    assert repr(dec.model_flops(QWEN, ROWS, [])) == "7756136316928.0"
    assert repr(dec.model_flops(LLAVA, ROWS, [])) == "92216014929920.0"
    assert repr(count.decode_call(QWEN, [1, 17, 4096, 999])) \
        == "(41885696.0, 5269768.0)"
    assert repr(count.prefill_call(
        LLAVA, [(0, 1024), (99, 1), (3000, 256), (7, 0)])) \
        == "(38013222912.0, 54670412.0)"
    for name, want in (("qwen2.5-3b", QWEN), ("llava-next-34b", LLAVA)):
        c = json.load(open(os.path.join(BENCH, "configs", f"{name}.json")))
        assert dec.shape(c, 16) == want
        # the shape the kernels count is the program's own config's
        p = dec.port_config(c)
        assert want == count.Shape(p.num_layers, p.d_model, p.num_heads,
                                   p.num_kv_heads, p.head_dim, p.d_ff,
                                   p.vocab_size, 16)


def test_a_family_is_chosen_by_name_and_must_exist(tmp_path, monkeypatch):
    assert families.name(TINY_CONFIG) == "decoder"
    for bad in ("../decoder", "a.b", ""):
        with pytest.raises(ValueError):
            families.name({"family": bad})
    with pytest.raises(KeyError):
        families.load({"family": "nowhere"})
    (tmp_path / "partial.py").write_text("def leaf_specs(config):\n"
                                         "    return []\n")
    monkeypatch.setattr(families, "PATH", families.PATH + [str(tmp_path)])
    with pytest.raises(AttributeError, match="port_config"):
        families.load({"family": "partial"})


def test_inputs_draw_from_their_own_stream():
    mix = copy.deepcopy(tiny_cell().traffic)
    plain = Traffic(mix, 1000, 10.0)
    drawn = Traffic(mix, 1000, 10.0,
                    inputs=lambda a, rng: {"x": int(rng.integers(1 << 30))})
    for a, b in ((plain.period(7, 0), drawn.period(7, 0)),
                 (plain.period(7, 1), drawn.period(7, 1)),
                 (plain.warmup(7), drawn.warmup(7))):
        assert [(x.index, x.due, x.output_len) for x in a] \
            == [(y.index, y.due, y.output_len) for y in b]
        assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
        assert all(x.inputs == {} for x in a)
    window = drawn.period(7, 1)
    assert [y.inputs["x"] for y in window] == [
        int(rng_for(7, "inputs", 0, y.index).integers(1 << 30))
        for y in window]
    warm = drawn.warmup(7)
    assert [y.inputs["x"] for y in warm] == [
        int(rng_for(7, "inputs", 1, y.index).integers(1 << 30))
        for y in warm]


#: a second family, as a later configuration would add it: the decoder's
#: layout, each hook's calls recorded, and one extra input a request,
#: which its Request and its reference both receive
RECORDING = '''
from families import decoder

CALLS = []
SEEN = []
EXTRAS = []


def _recorded(name, hook):
    def call(*a, **kw):
        CALLS.append(name)
        return hook(*a, **kw)
    return call


port_config = _recorded("port_config", decoder.port_config)
leaf_specs = _recorded("leaf_specs", decoder.leaf_specs)
group_std = _recorded("group_std", decoder.group_std)
tree = _recorded("tree", decoder.tree)
shape = _recorded("shape", decoder.shape)


def logits(params, config, seqs, mm=decoder.ref.exact_mm):
    CALLS.append("logits")
    SEEN.extend(inp for _, _, inp in seqs)
    return decoder.logits(params, config, seqs, mm)


def model_flops(shape, rows, extras):
    CALLS.append("model_flops")
    EXTRAS.append(list(extras))
    return decoder.model_flops(shape, rows, ()) + 1000.0 * len(extras)


def inputs(arrival, rng):
    CALLS.append("inputs")
    return {"tag": int(rng.integers(1 << 30)), "index": arrival.index}


def request_kwargs(arrival):
    CALLS.append("request_kwargs")
    return {"extra": arrival.inputs}
'''


def test_a_second_family_joins_as_one_module(tmp_path, monkeypatch):
    (tmp_path / "recording.py").write_text(RECORDING)
    monkeypatch.setattr(families, "PATH", families.PATH + [str(tmp_path)])
    from repro_torch.engine import request
    Request = request.Request
    made = []

    def recorded(**kw):
        made.append(kw.pop("extra"))
        return Request(**kw)

    monkeypatch.setattr(request, "Request", recorded)
    cell = tiny_cell()
    cell.config["family"] = "recording"
    fam = families.load(cell.config)
    torch.set_num_threads(2)
    result, compared = run.run(cell, 11, 2.0, False, device="cpu")
    assert result["correct"], compared
    # the run called every hook but those a traced run reads
    assert set(families.HOOKS) - set(fam.CALLS) == {"shape", "model_flops"}
    # each Request got its arrival's inputs
    assert made and all("tag" in x for x in made)
    # the reference got the inputs of the requests it compared
    assert len(fam.SEEN) == compared["widest_logit_gap"]["requests"]
    assert all(any(s is m for m in made) for s in fam.SEEN)

    # the traced run's mfu counts the model FLOPs the family gives,
    # with the inputs of the requests whose prefill starts in the slice
    shape = fam.shape(cell.config, 16)
    d = Dispatch(0, "mixed", 0.0, 1, [(40, 1)], [(0, 24, True), (8, 8, False)],
                 False, 0, started=[5])
    view = readout.RunView(
        shape=shape, family=fam, inputs={5: {"tag": 1}},
        device="NVIDIA H100 80GB HBM3", power_limit_w=700.0,
        profile={"window_s": 2.0}, slice=[d], window=[], lags=[],
        transfers=0, finished=0, pool_blocks=[1])
    rows = [(0, 24, True), (8, 8, False), (40, 1, True)]
    want = families.load(TINY_CONFIG).model_flops(shape, rows, ())
    assert readout.mfu(view) == pytest.approx(
        100.0 * (want + 1000.0) / (2.0 * 989e12), rel=1e-12)
    assert fam.EXTRAS[-1] == [{"tag": 1}]
