"""``program_spans`` and the readers of the program's spans on a synthetic
traced window: the spans cut to the harness's calls, each idle instant
given to the innermost program span, ``*.wait`` spans apart, and None
without a trace or without spans."""

import pytest
import torch

from kwsbench import program_spans, run
from kwsbench.trace import Summary
from multilingual_kws_tpu_torch.utils import profiling
from multilingual_kws_tpu_torch.utils.profiling import Span

# ns on the profiler's clock: two harness calls, device intervals (two
# overlapping), and the program's spans, the second call's root reaching
# past its harness call and one root outside every call
CALLS = [(0, 1000, "calculate_streaming_accuracy"), (2000, 2600, "calculate_streaming_accuracy")]
DEVICE = [(100, 200, "k"), (150, 300, "k"), (500, 600, "k"), (2100, 2200, "k")]
SCAN = [
    Span(0, "engine.scan", 50, 950, None, 0, {}),
    Span(1, "engine.read_wav", 60, 90, 0, 0, {}),
    Span(2, "engine.predict", 100, 400, 0, 0, {"batches": 1}),
    Span(3, "engine.wait", 400, 700, 0, 0, {}),
    Span(4, "engine.detect", 700, 800, 0, 0, {}),
    Span(5, "engine.scan", 1900, 2700, None, 5, {}),
    Span(6, "engine.wait", 2050, 2300, 5, 5, {}),
    Span(7, "engine.scan", 3000, 3100, None, 7, {}),
]


def _summary():
    return Summary(2000e-9, DEVICE, CALLS)


@pytest.fixture
def spans(monkeypatch):
    given = {"spans": SCAN}
    monkeypatch.setattr(program_spans, "recorded", lambda: given["spans"] or None)
    return given


def test_idle_is_given_to_the_innermost_span_inside_the_harness_calls(spans):
    found = program_spans.attribution(_summary())
    assert [(s.name, s.start, s.end) for s in found.spans] == [
        ("engine.scan", 50, 950), ("engine.read_wav", 60, 90), ("engine.predict", 100, 400),
        ("engine.wait", 400, 700), ("engine.detect", 700, 800), ("engine.scan", 2000, 2600),
        ("engine.wait", 2050, 2300)]
    # the root's own idle: 50-60, 90-100, 800-950 and, cut, 2000-2050, 2300-2600
    assert dict(found.idle_by_name) == {"engine.scan": 520, "engine.read_wav": 30, "engine.predict": 100,
                                        "engine.wait": 350, "engine.detect": 100}
    assert (found.idle_ns(waiting=True), found.idle_ns(waiting=False)) == (350, 750)
    assert [s.id for s in found.roots("engine.scan")] == [0, 5]
    assert found.wall("engine.wait") == 550 and found.wall("engine.wait", "engine.scan") == 550


def test_the_idle_readers_split_the_idle_share(spans):
    trace = _summary()
    host = run.metric_reader("idle_host.scan")(trace, None, {})
    waiting = run.metric_reader("idle_waiting.scan")(trace, None, {})
    share = run.metric_reader("idle_share.scan")(trace, None, {})
    assert host == pytest.approx(37.5) and waiting == pytest.approx(17.5) and share == pytest.approx(80.0)
    assert host + waiting <= share


def test_the_stage_readers_divide_by_their_calls(spans):
    trace = _summary()
    assert run.metric_reader("read_ms_per_stream.scan")(trace, None, {}) == pytest.approx(15e-6)
    assert run.metric_reader("detect_ms_per_stream.scan")(trace, None, {}) == pytest.approx(50e-6)
    assert run.metric_reader("call_start_s.pretrain")(trace, None, {}) is None  # no pretrain.call
    spans["spans"] = [
        Span(0, "finetune.call", 0, 900, None, 0, {"graphs_kept": 10}),
        Span(1, "finetune.start", 10, 110, 0, 0, {}),
        Span(2, "graphs.capture", 200, 260, 0, 0, {}),
        Span(3, "finetune.evaluate", 700, 800, 0, 0, {"batches": 1}),
        Span(4, "finetune.call", 2000, 2500, None, 4, {"graphs_kept": 13}),
        Span(5, "finetune.start", 2000, 2100, 4, 4, {}),
        Span(6, "graphs.capture", 2100, 2140, 4, 4, {}),
        Span(7, "finetune.call", 2500, 2600, None, 7, {"graphs_kept": 16}),
        Span(8, "graphs.capture", 2510, 2520, None, 8, {}),  # another entry point's, not the call's
    ]
    trace = _summary()
    assert run.metric_reader("start_ms_per_keyword.finetune")(trace, None, {}) == pytest.approx(200 / 3 * 1e-6)
    assert run.metric_reader("capture_ms_per_keyword.finetune")(trace, None, {}) == pytest.approx(100 / 3 * 1e-6)
    assert run.metric_reader("evaluate_ms_per_keyword.finetune")(trace, None, {}) == pytest.approx(100 / 3 * 1e-6)
    assert run.metric_reader("graphs_kept_per_keyword.finetune")(trace, None, {}) == 3.0


NEW = ["read_ms_per_stream.scan", "detect_ms_per_stream.scan", "call_start_s.pretrain", "capture_s.pretrain",
       "start_ms_per_keyword.finetune", "capture_ms_per_keyword.finetune", "evaluate_ms_per_keyword.finetune",
       "graphs_kept_per_keyword.finetune", "idle_host.scan", "idle_waiting.scan"]


@pytest.mark.parametrize("name", NEW)
def test_each_reader_is_silent_without_a_trace_or_spans(spans, name):
    read = run.metric_reader(name)
    assert read(None, None, {}) is None
    spans["spans"] = []
    assert read(_summary(), None, {}) is None
    spans["spans"] = [Span(0, "engine.scan", 3000, 3100, None, 0, {})]  # outside the harness's calls
    assert read(_summary(), None, {}) is None


def test_the_ports_recorder_is_read():
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("engine.scan"):
            pass
    assert [s.name for s in program_spans.recorded()] == ["engine.scan"]
    profiling.clear()
    assert program_spans.recorded() is None
