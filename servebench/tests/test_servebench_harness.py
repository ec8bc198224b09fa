"""The harness's arithmetic and its discovery of cells, mixes and
metrics."""
from __future__ import annotations

import collections
import json
import math
import shutil

import numpy as np
import pytest

from conftest import BENCH, ROOT, TINY_TRAFFIC
from harness import measure, spec, traffic
from harness.measure import INF, NEVER, Timed
from harness.traffic import Traffic


def timed(due, first, last, tokens, target=None, finished=True):
    return Timed(due, 100, target or tokens, first, last, tokens, finished)


def test_percentile_interpolates_like_numpy():
    xs = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.0]
    for q in (0, 10, 50, 90, 100):
        assert measure.percentile(xs, q) == pytest.approx(
            np.percentile(xs, q))


def test_percentile_keeps_infinite_misses():
    xs = [0.1 * i for i in range(1, 10)] + [INF]
    assert math.isinf(measure.percentile(xs, 95))
    assert measure.percentile(xs, 50) == pytest.approx(
        np.percentile(xs[:-1] + [100.0], 50))
    # more than a tenth never got a first token: p90 is infinite
    assert math.isinf(measure.percentile([1.0] * 8 + [INF, INF], 90))
    assert measure.finite(INF) == NEVER


def test_ttft_tpot_and_attainment():
    ok = timed(0.0, 0.5, 0.5 + 0.05 * 9, 10)
    slow_first = timed(1.0, 3.5, 4.0, 10)
    slow_tokens = timed(2.0, 2.2, 2.2 + 0.2 * 9, 10)
    never = Timed(3.0, 100, 10)
    unfinished = timed(4.0, 4.1, 4.5, 5, target=10, finished=False)
    reqs = [ok, slow_first, slow_tokens, never, unfinished]
    assert ok.ttft() == pytest.approx(0.5)
    assert ok.tpot() == pytest.approx(0.05)
    assert math.isinf(never.ttft()) and math.isinf(never.tpot())
    assert math.isinf(unfinished.tpot())
    assert measure.attainment(reqs, 2.0, 0.1) == pytest.approx(1 / 5)
    failed = timed(0.0, 0.1, 0.2, 2)
    failed.failed = True
    assert not measure.meets(failed, 2.0, 0.1)


def test_deadline_settles_a_request():
    r = Timed(10.0, 100, 11)
    assert r.deadline(2.0, 0.1) == 12.0
    assert not r.settled(11.9, 2.0, 0.1) and r.settled(12.1, 2.0, 0.1)
    r.first = 11.0
    assert r.deadline(2.0, 0.1) == pytest.approx(12.0)
    r.finished = True
    assert r.settled(0.0, 2.0, 0.1)


def test_tokens_per_s_counts_the_window_only():
    reqs = [timed(0.0, 1.0, 5.0, 10), timed(8.0, 9.5, 12.0, 10),
            timed(9.0, 10.5, 11.0, 3), Timed(9.5, 100, 4)]
    # prompts of the two requests whose first token came before 10 s,
    # and the 17 tokens the sink counted before the close
    assert measure.tokens_per_s(reqs, 17, 10.0) == pytest.approx(
        (200 + 17) / 10.0)


def make(mix=TINY_TRAFFIC, period=10.0):
    return Traffic(mix, vocab_size=1000, period_s=period)


def test_generator_is_deterministic_from_the_seed():
    big = 2 ** 33 + 17
    a, b = make().period(big, 0), make().period(big, 0)
    assert [x.due for x in a] == [x.due for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    c = make().period(big + 1, 0)
    assert not all(np.array_equal(x.prompt, y.prompt)
                   for x, y in zip(a, c))


def test_every_seed_gets_the_same_work_in_its_own_order():
    t = make()
    a, b = t.period(1, 0), t.period(2, 0)
    assert len(a) == len(b) == round(TINY_TRAFFIC["arrivals"]["rate_per_s"]
                                     * 10)
    # the same sizes and gaps, in the seed's order
    assert sorted(len(x.prompt) for x in a) == sorted(
        len(x.prompt) for x in b)
    assert sorted(x.output_len for x in a) == sorted(
        x.output_len for x in b)
    gaps = lambda xs: np.sort(np.diff([x.due for x in xs] + [10.0]))
    assert [len(x.prompt) for x in a] != [len(x.prompt) for x in b]
    assert [x.due for x in a] != [x.due for x in b]
    # the seed draws the tokens
    assert not np.array_equal(a[0].prompt, b[0].prompt)
    # the same seed, the same order
    assert [x.due for x in t.period(1, 0)] == [x.due for x in a]
    # inside the period, and the next period follows it
    assert all(0 <= x.due < 10.0 for x in a)
    assert np.allclose(gaps(a), gaps(b), rtol=0, atol=1e-9)
    nxt = t.period(1, 1)
    assert all(10.0 <= x.due < 20.0 for x in nxt)
    assert nxt[0].index == len(a)


def test_the_order_is_balanced():
    rng = np.random.default_rng(5)
    values = np.arange(45)
    out = traffic.balanced(rng, values, block=8)
    assert sorted(out) == list(values)
    which = {v: v // 6 for v in values}     # six runs: strata of six
    # 45 = three runs of 8 and three of 7
    ends = np.cumsum([0] + [8] * 3 + [7] * 3)
    for a, b in zip(ends[:-1], ends[1:]):
        run = [which[v] for v in out[a:b]]
        assert len(set(run)) == len(run)
    # fewer values than a run: a plain permutation
    assert sorted(traffic.balanced(rng, np.arange(5), 8)) == list(range(5))
    # the seed's order differs from another's
    assert list(traffic.balanced(np.random.default_rng(6), values)) \
        != list(out)


def test_lengths_follow_the_law():
    # the quantiles' histogram is that of sim.workload.LengthDist's draws
    d = make().prompt
    q = d.quantiles(10_000)
    x = np.random.default_rng(0).lognormal(d.mu, d.sigma, size=10_000)
    s = np.clip(x.astype(int), d.lo, d.hi)
    for p in (10, 50, 90):
        assert abs(np.percentile(q, p) - np.percentile(s, p)) \
            <= 0.05 * np.percentile(s, p)
    assert q.min() >= d.lo and q.max() <= d.hi


def test_bursts_and_shared_prefixes():
    mix = dict(TINY_TRAFFIC, arrivals={
        "rate_per_s": 10.0, "bursts": {"every_s": 5.0, "length_s": 1.0,
                                       "factor": 4.0}},
        shared_prefix={"groups": 2, "tokens": 8})
    t = make(mix)
    arr = t.period(3, 0)
    # 10 / s, four times that for 1 s in every 5: 10 x (10 + 2 x 3), half
    # of them inside the bursts (on average over seeds)
    assert len(arr) == 160
    inside = [sum((x.due % 5.0) < 1.0 for x in t.period(s, 0))
              for s in range(20)]
    assert np.mean(inside) == pytest.approx(80, rel=0.05)
    heads = collections.Counter(tuple(x.prompt[:8]) for x in arr)
    assert len(heads) == 2


def test_warmup_burst_is_another_stream():
    t = make()
    w = t.warmup(1)
    assert len(w) == TINY_TRAFFIC["warmup"]["requests"]
    assert all(x.due == 0.0 for x in w)
    assert max(len(x.prompt) for x in w) == t.prompt.hi
    assert all(x.output_len <= TINY_TRAFFIC["warmup"]["max_output"]
               for x in w)
    first = t.period(1, 0)[0].prompt
    assert not any(np.array_equal(first[:16], x.prompt[:16]) for x in w)


def test_a_cell_a_mix_and_a_metric_added_as_files_are_found(tmp_path):
    shutil.copytree(BENCH, tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(f"{ROOT}/BENCHMARK.json"))
    cfg = bench["configs"][0]
    (tmp_path / "servebench" / "traffic" / "newmix.json").write_text(
        json.dumps(TINY_TRAFFIC))
    (tmp_path / "servebench" / "metrics" / "new_metric.newmix.py"
     ).write_text("def read(run):\n    return run['x'] * 2\n")
    bench["workloads"].append({"name": "x.newmix", "config": cfg["name"],
                               "traffic": "newmix", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "tokens_per_s", "unit": "tokens/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["x.newmix"]})
    bench["per_layer"].append({"name": "new_metric.newmix", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "executor", "moves": "tokens_per_s",
                               "workloads": ["x.newmix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("x.newmix", root=tmp_path)
    assert cell.traffic == TINY_TRAFFIC
    assert sorted(m["name"] for m in cell.end_to_end) == [
        "setup_s", "tokens_per_s"]
    assert [m["name"] for m in cell.per_layer] == ["new_metric.newmix"]
    got = spec.read_metrics(cell.per_layer, {"x": 2.5}, root=tmp_path)
    assert got == {"new_metric.newmix": {"value": 5.0, "unit": "ms"}}
    # the existing cells are unchanged
    old = spec.load_cell(bench["workloads"][0]["name"], root=tmp_path)
    assert "new_metric.newmix" not in [m["name"] for m in old.per_layer]


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tmp_path):
    (tmp_path / "servebench" / "metrics").mkdir(parents=True)
    (tmp_path / "servebench" / "metrics" / "m.py").write_text(
        "def read(run):\n    return None\n")
    assert spec.read_metrics([{"name": "m", "unit": "%"}], object(),
                             root=tmp_path) == {}


def test_a_metric_split_by_cell_is_read_by_its_base_reader(tmp_path):
    d = tmp_path / "servebench" / "metrics"
    d.mkdir(parents=True)
    (d / "m.py").write_text("def read(run):\n    return run * 2\n")
    (d / "m.b.py").write_text("def read(run):\n    return run * 3\n")
    got = spec.read_metrics([{"name": "m.a", "unit": "ms"},
                             {"name": "m.b", "unit": "ms"}], 1.5,
                            root=tmp_path)
    assert got == {"m.a": {"value": 3.0, "unit": "ms"},
                   "m.b": {"value": 4.5, "unit": "ms"}}


def test_every_per_layer_metric_has_a_reader():
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        assert spec.reader_path(m["name"]).exists(), m["name"]
