"""The port's span registry (utils/metrics.py) and the spans of the
encoder-training loop (tools/train_encoder.py, parallel/train.py), on the
CPU: nesting, clock, ring, threads, the profiler ranges, /stats' shape,
and one span of each phase per step of a tiny ``train_encoder.main``."""

import dataclasses
import logging
import math
import threading
import time

import pytest
import torch

from rag_icd10_tpu_torch import config as tconfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.tools import train_encoder as ttool
from rag_icd10_tpu_torch.utils.metrics import StageMetrics, metrics, self_ns

torch.set_num_threads(2)  # the suite runs several test processes at once

DRAW = ("train.draw", "train.draw.sample", "train.draw.tokenize")
STEP = ("train.step", "train.step.forward", "train.step.backward", "train.step.update")


def test_nested_spans_take_parent_and_id():
    reg = StageMetrics()
    with reg.span("outer", id=7):
        with reg.span("mid"):
            with reg.span("inner", id=99):  # a nested span keeps its parent's id
                pass
        with reg.span("mid"):
            pass
    with reg.span("alone"):
        pass
    (outer,) = reg.spans("outer")
    mids = reg.spans("mid")
    (inner,) = reg.spans("inner")
    (alone,) = reg.spans("alone")
    assert (outer.parent, outer.id) == (None, 7)
    assert [(m.parent, m.id) for m in mids] == [("outer", 7), ("outer", 7)]
    assert (inner.parent, inner.id) == ("mid", 7)
    assert (alone.parent, alone.id) == (None, None)


def test_times_are_time_ns_and_ordered():
    reg = StageMetrics()
    before = time.time_ns()
    with reg.span("a"):
        time.sleep(0.002)
        with reg.span("b"):
            time.sleep(0.002)
    after = time.time_ns()
    (a,), (b,) = reg.spans("a"), reg.spans("b")
    assert before <= a.start_ns <= b.start_ns < b.end_ns <= a.end_ns <= after
    assert b.end_ns - b.start_ns >= 2_000_000
    assert self_ns(a, [b]) == (a.end_ns - a.start_ns) - (b.end_ns - b.start_ns)
    # a span of another parent or id is no child
    assert self_ns(a, [b._replace(id=3)]) == a.end_ns - a.start_ns
    assert reg.spans("a", since_ns=a.start_ns + 1) == []
    assert reg.spans("a", until_ns=a.start_ns - 1) == []


def test_a_full_ring_counts_what_it_drops():
    reg = StageMetrics(window=4)
    for i in range(6):
        with reg.span("s", id=i):
            pass
    assert reg.dropped("s") == 2
    assert reg.snapshot()["s"]["count"] == 6
    assert reg.spans("s") is None  # the dropped spans ended after since_ns
    assert reg.spans("s", since_ns=time.time_ns()) == []
    oldest_held = reg._spans["s"][0].start_ns
    assert [s.id for s in reg.spans("s", since_ns=oldest_held)] == [2, 3, 4, 5]
    reg.reset()
    assert reg.dropped("s") == 0 and reg.spans("s") == []


def test_threads_keep_their_own_stacks():
    reg = StageMetrics()
    both_open = threading.Barrier(2, timeout=10)
    both_nested = threading.Barrier(2, timeout=10)

    def work(name, ident):
        with reg.span(name, id=ident):
            both_open.wait()
            with reg.span("child"):
                both_nested.wait()

    threads = [threading.Thread(target=work, args=(f"top{i}", i)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert sorted((c.parent, c.id) for c in reg.spans("child")) == [("top0", 0), ("top1", 1)]


def test_profiler_range_only_while_a_profiler_runs():
    reg = StageMetrics()
    with reg.span("probe.before") as s:
        assert s.rf is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with reg.span("probe.during") as s:
            assert s.rf is not None
            torch.ones(4).sum()
    with reg.span("probe.after") as s:
        assert s.rf is None
    keys = {e.key for e in prof.key_averages()}
    assert "probe.during" in keys
    assert not {"probe.before", "probe.after"} & keys
    assert len(reg.spans("probe.during")) == 1


def test_snapshot_keeps_its_keys():
    reg = StageMetrics()
    for _ in range(3):
        with reg.timer("encode"):
            time.sleep(0.002)
    snap = reg.snapshot()
    assert set(snap) == {"encode"}
    assert set(snap["encode"]) == {"count", "p50_ms", "p95_ms", "mean_ms", "last_ms"}
    assert snap["encode"]["count"] == 3
    assert 2.0 <= snap["encode"]["p50_ms"] <= snap["encode"]["p95_ms"]


# ------------------------------------------------------ the training loop


@pytest.fixture
def tiny_cli(tmp_path, monkeypatch):
    """A 2-layer, 32-wide encoder config over a 300-row synthetic CSV."""
    corpus = synthetic_corpus(300, seed=3)
    csv = tmp_path / "icd.csv"
    csv.write_text("code,disease\n" + "\n".join(
        f"{r.code},{r.preferred_zh}" for r in corpus.records()), encoding="utf-8")
    base = tconfig.Config()
    cfg = dataclasses.replace(
        base, data_path=str(csv),
        encoder=tconfig.EncoderConfig(hidden_size=32, num_layers=2, num_heads=2,
                                      intermediate_size=64, weights_path=None,
                                      vocab_path=None, dtype="float32"),
        store=dataclasses.replace(base.store, db_path=str(tmp_path / "db" / "s")),
    )
    monkeypatch.setattr(tconfig, "get_config", lambda: cfg)
    return tmp_path


ARGS = ["--batch", "16", "--seq-a", "16", "--seq-b", "32", "--log-every", "1"]


def _run(tiny_cli, steps, *extra):
    since = time.time_ns()
    rc = ttool.main(ARGS + ["--steps", str(steps), "--out", str(tiny_cli / "run")]
                    + list(extra), device="cpu")
    assert rc == 0
    return {name: metrics.spans(name, since) for name in DRAW + STEP}


def _inside(child, parent):
    return (parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns
            and child.parent == parent.name and child.id == parent.id)


def test_cli_records_one_span_of_each_phase_a_step(tiny_cli, caplog):
    with caplog.at_level(logging.INFO, logger="rag_icd10_tpu_torch.train"):
        got = _run(tiny_cli, 3)
    for name in DRAW + STEP:
        assert [s.id for s in got[name]] == [0, 1, 2], name
    for step in range(3):
        draw, sample, tokenize = (got[n][step] for n in DRAW)
        whole, forward, backward, update = (got[n][step] for n in STEP)
        assert draw.parent is None and whole.parent is None
        assert _inside(sample, draw) and _inside(tokenize, draw)
        assert sample.end_ns <= tokenize.start_ns
        for phase in (forward, backward, update):
            assert _inside(phase, whole)
        assert forward.end_ns <= backward.start_ns and backward.end_ns <= update.start_ns
        assert draw.end_ns <= whole.start_ns
    # the operator's line: draw, step and the step's self time of the
    # interval, then the share of the tokenizer's piece lookups that hit
    lines = [r for r in caplog.records if str(r.msg).startswith("step %d/%d loss=")]
    assert len(lines) == 3
    for r in lines:
        draw_ms, step_ms, wait_ms, hit_pct = r.args[-4:]
        assert all(math.isfinite(x) for x in (draw_ms, step_ms, wait_ms))
        assert 0 < wait_ms < step_ms
        assert 0 <= hit_pct <= 100
    assert "wait" in lines[-1].getMessage() and "piece memo" in lines[-1].getMessage()


def test_cli_plain_pairs_records_the_draw_and_the_step(tiny_cli):
    got = _run(tiny_cli, 2, "--plain-pairs")
    assert got["train.draw.sample"] == [] and got["train.draw.tokenize"] == []
    for name in ("train.draw",) + STEP:
        assert [s.id for s in got[name]] == [0, 1], name
    for step in range(2):
        whole = got["train.step"][step]
        assert all(_inside(got[n][step], whole) for n in STEP[1:])


def test_interval_split_reads_the_registry():
    reg = StageMetrics()
    for step in range(2):
        with reg.span("train.draw", id=step):
            time.sleep(0.001)
        with reg.span("train.step", id=step):
            for name in ttool.STEP_PHASES:
                with reg.span(name):
                    time.sleep(0.001)
            time.sleep(0.002)
    draw_ms, step_ms, wait_ms = ttool.interval_split_ms(reg, 0)
    assert 1.0 <= draw_ms < step_ms
    assert 2.0 <= wait_ms < step_ms - 3.0
    assert all(math.isnan(x) for x in ttool.interval_split_ms(reg, time.time_ns()))


def test_the_ring_holds_a_window_of_per_layer_spans():
    """A training window of the Moonlight cell records each of ``mla``,
    ``moe.route``, ``moe.experts`` and ``moe.shared`` about ten times a step
    (two forward calls over five or four layers) over about 70 steps, warm
    steps and the compared ones included: the default ring keeps them all,
    so a reader of the window gets every one (not None)."""
    from rag_icd10_tpu_torch.utils.metrics import RING

    reg = StageMetrics()
    assert reg.window == RING >= 8192
    since = time.time_ns()
    for step in range(70):
        with reg.span("train.step", id=step):
            with reg.span("train.step.forward"):
                for _ in range(2):  # anchors with hard negatives, then positives
                    for _ in range(5):
                        with reg.span("mla"):
                            pass
                    for _ in range(4):
                        for name in ("moe.route", "moe.experts", "moe.shared"):
                            with reg.span(name):
                                pass
    for name, per_step in (("mla", 10), ("moe.route", 8), ("moe.experts", 8)):
        got = reg.spans(name, since)
        assert got is not None and len(got) == 70 * per_step and reg.dropped(name) == 0
        assert {s.parent for s in got} == {"train.step.forward"}
        assert [s.id for s in got[::per_step]] == list(range(70))


def test_counters_add_on_the_device_and_read_on_demand():
    reg = StageMetrics()
    # a known routing: 5 tokens, top 2 over 4 experts, of which 1 and 3 are held here
    idx = torch.tensor([[1, 0], [3, 1], [2, 0], [1, 3], [0, 2]])
    for _ in range(3):
        held = torch.stack([(idx == e).sum() for e in (1, 3)])
        reg.count("moe.held_slots.1", held)
        reg.count("moe.routed_slots.1", idx.numel())
    got = reg.counters("moe.")
    assert got["moe.held_slots.1"].tolist() == [9, 6]
    assert int(got["moe.routed_slots.1"]) == 30
    assert isinstance(reg._counters["moe.held_slots.1"], torch.Tensor)  # kept where it lives
    got["moe.held_slots.1"][0] = -1  # a read is a copy
    assert reg.counters()["moe.held_slots.1"].tolist() == [9, 6]
    with pytest.raises(ValueError, match="shape"):
        reg.count("moe.held_slots.1", torch.zeros(3, dtype=torch.long))
    assert reg.counters("train.") == {}
    reg.reset()
    assert reg.counters() == {}
