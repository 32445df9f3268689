"""The port's profiling hooks (utils/profiling.py) and build cache
(utils/compilation_cache.py) against the JAX package's, and the port's
spans.

``PhaseTimer`` runs one scripted sequence of nested phases in both packages
on one scripted clock, so the counts, totals and reports must be ``==``.
``trace`` on the CPU writes a Chrome trace that holds the annotated range,
and the spans beside it. ``enable_compilation_cache`` does nothing without
a card, as the JAX one does on the CPU.

Spans: without a profiler ``annotate`` records nothing and never enters
``record_function``; under one they nest by parent and call, lie on the
profiler's clock, and each entry point (the engine's scan, the fine-tune,
pretraining) records its stages in order under one call. ``graphs.kept``
counts the graphs alive (a stub graph here: the CPU has no CUDA graph).
The engine's ``engine.read_wav`` counts the samples read and whether they
went to the frontend as the file's int16 (``pcm16``); ``engine.cast``
appears only where a stream is quantised.
"""

import gc
import itertools
import json
import time

import numpy as np
import pytest
import torch

from helpers import make_corpus, pcm_wav
from multilingual_kws_tpu.utils import profiling as jax_profiling
from multilingual_kws_tpu_torch.models.efficientnet import BlockArgs, EfficientNet
from multilingual_kws_tpu_torch.models.kws_model import KWSEmbeddingModel, KWSTransferModel, lecun_init_
from multilingual_kws_tpu_torch.ops import _build
from multilingual_kws_tpu_torch.stream import engine
from multilingual_kws_tpu_torch.train import graphs
from multilingual_kws_tpu_torch.train.finetune import transfer_learn
from multilingual_kws_tpu_torch.train.pretrain import PretrainConfig, pretrain
from multilingual_kws_tpu_torch.utils import compilation_cache, profiling
from multilingual_kws_tpu_torch.utils.wav import write_wav


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scripted(timer_cls, monkeypatch):
    clock = itertools.count(0.0, 0.125)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    t = timer_cls()
    for _ in range(3):
        with t.phase("epoch"):
            for _ in range(2):
                with t.phase("epoch/step"):
                    pass
            with t.phase("epoch/eval"):
                pass
    with t.phase("save"):
        pass
    return t


def test_phase_timer_matches_jax(monkeypatch):
    got = _scripted(profiling.PhaseTimer, monkeypatch)
    want = _scripted(jax_profiling.PhaseTimer, monkeypatch)
    monkeypatch.undo()
    assert dict(got.counts) == dict(want.counts) == {"epoch": 3, "epoch/step": 6, "epoch/eval": 3, "save": 1}
    assert got.as_dict() == want.as_dict()
    assert got.report() == want.report()
    assert got.report().splitlines()[0].split() == ["phase", "total_s", "calls", "mean_ms"]


def test_phase_timer_counts_a_failing_phase():
    t = profiling.PhaseTimer()
    with pytest.raises(ValueError):
        with t.phase("boom"):
            raise ValueError
    assert t.counts["boom"] == 1 and not t._stack


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    timer = profiling.PhaseTimer()
    with profiling.trace(tmp_path / "trace") as path:
        with timer.phase("featurize"):
            with profiling.annotate("inner_range"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert path.parent == tmp_path / "trace" and path.exists()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"featurize", "inner_range"} <= names
    assert timer.counts["featurize"] == 1
    spans = [json.loads(line) for line in path.with_name(path.name.replace(".pt.trace.json", ".spans.jsonl"))
             .read_text().splitlines()]
    assert [(s["name"], s["parent"]) for s in spans] == [("featurize", None), ("inner_range", spans[0]["id"])]
    assert {s["call"] for s in spans} == {spans[0]["id"]}


def test_compilation_cache_is_off_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MKWS_COMPILATION_CACHE", str(tmp_path / "cache"))
    before = _build.BUILD_DIR
    assert compilation_cache.enable_compilation_cache() is False
    assert compilation_cache.enable_compilation_cache(str(tmp_path / "other")) is False
    assert _build.BUILD_DIR == before
    assert not (tmp_path / "cache").exists() and not (tmp_path / "other").exists()


def test_compilation_cache_moves_the_build_directory_on_a_card(monkeypatch, tmp_path):
    """With a card (simulated: nothing is built here), the build directory
    moves to the path, else $MKWS_COMPILATION_CACHE, else ~/.cache/...; the
    native libraries' names follow it."""
    from multilingual_kws_tpu_torch import native

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    assert compilation_cache.enable_compilation_cache(str(tmp_path / "given")) is True
    assert _build.BUILD_DIR == tmp_path / "given" and _build.BUILD_DIR.is_dir()
    assert native.target("wavloader").parent == tmp_path / "given"
    assert _build._target("frontend").parent == tmp_path / "given"
    monkeypatch.setenv("MKWS_COMPILATION_CACHE", str(tmp_path / "env"))
    assert compilation_cache.enable_compilation_cache() is True and _build.BUILD_DIR == tmp_path / "env"
    monkeypatch.delenv("MKWS_COMPILATION_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert compilation_cache.enable_compilation_cache() is True
    assert _build.BUILD_DIR == tmp_path / "home" / ".cache" / "multilingual_kws_tpu_torch" / "build"


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_annotate_records_nothing_without_a_profiler(monkeypatch):
    """With no profiler a span is one flag check and a shared handle: no
    ``record_function``, no timestamp, nothing kept."""

    def refuse(*a, **k):
        raise AssertionError("entered without a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    profiling.clear()
    assert not torch.autograd._profiler_enabled()
    handles = set()
    for name in ("a", "b"):
        with profiling.annotate(name) as span:
            span.count(n=3)
            handles.add(id(span))
    assert profiling.spanned("root")(lambda x: x + 1)(1) == 2
    with profiling.PhaseTimer().phase("phase"):
        pass
    assert len(handles) == 1 and profiling.recorded() == [] and profiling.dropped() == 0


def test_spans_nest_by_parent_and_call_under_a_profiler():
    profiling.clear()

    @profiling.spanned("root", lambda: {"closed": 7})
    def entry():
        with profiling.annotate("outer") as outer:
            outer.count(items=2)
            with profiling.annotate("inner") as inner:
                inner.count(items=1)
                inner.count(items=4)
        with profiling.annotate("after"):
            pass

    with _profiled():
        entry()
        entry()
    spans = profiling.recorded()
    assert [s.name for s in spans] == ["root", "outer", "inner", "after"] * 2
    for call in (spans[:4], spans[4:]):
        root, outer, inner, after = call
        assert root.parent is None and {s.call for s in call} == {root.id}
        assert outer.parent == root.id and inner.parent == outer.id and after.parent == root.id
        assert root.counts == {"closed": 7} and outer.counts == {"items": 2} and inner.counts == {"items": 5}
        assert root.start_ns <= outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns <= after.start_ns
        assert after.end_ns <= root.end_ns
    assert spans[0].call != spans[4].call
    with profiling.annotate("off"):
        pass
    assert len(profiling.recorded()) == 8


def test_span_times_lie_on_the_profilers_clock():
    """Each span's start and end lie within 2 ms of its own profiler
    event's: the spans can be laid over the trace's device intervals."""
    profiling.clear()
    with _profiled() as prof:
        for i in range(5):
            with profiling.annotate(f"clock.{i}"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("clock.")}
    spans = profiling.recorded()
    assert [s.name for s in spans] == [f"clock.{i}" for i in range(5)]
    for s in spans:
        e = events[s.name]
        assert abs(s.start_ns - e.start_ns()) < 2_000_000, (s, e.start_ns())
        assert abs(s.end_ns - (e.start_ns() + e.duration_ns())) < 2_000_000


def test_the_recorders_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    profiling.clear()
    with _profiled():
        for _ in range(5):
            with profiling.annotate("capped"):
                pass
    assert len(profiling.recorded()) == 3 and profiling.dropped() == 2
    profiling.clear()
    assert profiling.recorded() == [] and profiling.dropped() == 0


class _StubGraph:
    """Stands for a CUDA graph, which the CPU cannot capture."""


def test_graphs_kept_counts_captures_and_releases(monkeypatch):
    """``graphs.captures`` counts every capture; ``graphs.kept`` the graphs
    alive: a graph dropped by its owner (a program's eviction, the owner's
    end) leaves it. Nothing else is deleted."""
    monkeypatch.setattr(graphs, "captures", graphs.captures)
    monkeypatch.setattr(graphs, "kept", graphs.kept)
    captures, kept = graphs.captures, graphs.kept
    owner = {k: _StubGraph() for k in range(3)}
    for k in owner:
        graphs._track(owner[k])
    assert (graphs.captures, graphs.kept) == (captures + 3, kept + 3)
    del owner[0]  # an eviction
    assert graphs.kept == kept + 2
    survivor = owner[1]
    owner.clear()  # the owner's end; one graph still referenced elsewhere
    gc.collect()
    assert (graphs.captures, graphs.kept) == (captures + 3, kept + 1)
    del survivor
    assert graphs.kept == kept


def _tiny_trunk():
    return EfficientNet(width_coefficient=0.25, depth_coefficient=0.4,
                        blocks=(BlockArgs(3, 1, 32, 16, 1, 1), BlockArgs(3, 1, 16, 24, 6, 2)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"), clips_per_word=6)


def _scan(corpus, tmp_path):
    rng = np.random.default_rng(3)
    wav = tmp_path / "stream.wav"
    write_wav(wav, (0.01 * rng.standard_normal(3 * 16000)).astype(np.float32))
    (tmp_path / "labels.txt").write_text("alpha, 1000\n")
    flags = engine.StreamFlags(wav=str(wav), ground_truth=str(tmp_path / "labels.txt"), target_keyword="alpha",
                               detection_thresholds=[0.5, 0.9])
    model = lecun_init_(KWSTransferModel(_tiny_trunk(), 3), 0).eval()
    engine.calculate_streaming_accuracy(model, [flags], batch_size=32, verbose=False, device="cpu")


def _finetune(corpus, tmp_path):
    transfer_learn("alpha", corpus["alpha"][:3], corpus["alpha"][3:5], corpus["unknown_files"], num_epochs=2,
                   batch_size=4, bg_datadir=corpus["bg_dir"], seed=0, verbose=0,
                   model=lecun_init_(KWSTransferModel(_tiny_trunk(), 3), 0), device="cpu")


def _pretrain(corpus, tmp_path):
    words = ["bravo", "charlie"]
    config = PretrainConfig(num_labels=4, batch_size=4, num_epochs=1, steps_per_epoch=2, resident_data=True,
                            device="cpu")
    pretrain([f for w in words for f in corpus[w][:4]], [f for w in words for f in corpus[w][4:]], words,
             corpus["bg_dir"], config=config, verbose=0, model=lecun_init_(KWSEmbeddingModel(4, _tiny_trunk()), 0))


ENTRY_SPANS = {
    "scan": (_scan, ["engine.scan", "engine.read_wav", "engine.frontend", "engine.predict", "engine.wait",
                     "engine.detect", "engine.score"]),
    "finetune": (_finetune, ["finetune.call", "finetune.start"]
                 + ["finetune.draws", "finetune.epoch", "finetune.wait", "finetune.evaluate"] * 2),
    "pretrain": (_pretrain, ["pretrain.call", "pretrain.start", "pretrain.draws", "pretrain.epoch", "pretrain.wait",
                             "pretrain.calibrate", "pretrain.validate"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_SPANS))
def test_each_entry_point_records_its_stages_under_one_call(entry, corpus, tmp_path):
    run, names = ENTRY_SPANS[entry]
    profiling.clear()
    with _profiled():
        run(corpus, tmp_path)
    spans = profiling.recorded()
    assert [s.name for s in spans] == names
    root = spans[0]
    assert root.parent is None and {s.call for s in spans} == {root.id}
    assert all(s.parent == root.id for s in spans[1:])
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in spans)
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans[1:], spans[2:]))
    counts = {s.name: s.counts for s in spans}
    if entry == "scan":
        assert counts["engine.predict"] == {"windows": 100, "batches": 4}
        assert counts["engine.read_wav"] == {"samples": 3 * 16000, "pcm16": 1}
    elif entry == "finetune":
        assert root.counts == {"graphs_kept": graphs.kept} and counts["finetune.epoch"] == {"steps": 4}
        assert counts["finetune.evaluate"] == {"batches": 1}
    else:
        assert root.counts == {"graphs_kept": graphs.kept} and counts["pretrain.epoch"] == {"steps": 2}


@pytest.mark.parametrize("stream", ["pcm16 wav", "pcm8 wav", "float chunks"])
def test_the_engine_counts_how_it_took_in_the_stream(stream, tmp_path):
    """A 16-bit wav goes to the frontend as its own samples (``pcm16`` 1, no
    ``engine.cast``); an 8-bit wav, and float audio handed to the chunks, are
    quantised under ``engine.cast``."""
    rng = np.random.default_rng(5)
    samples = (3000 * rng.standard_normal(3 * 16000)).astype(np.int16)
    wav = tmp_path / "stream.wav"
    pcm_wav(wav, samples, "pcm8" if stream == "pcm8 wav" else "pcm16-mono")
    (tmp_path / "labels.txt").write_text("alpha, 1000\n")
    flags = engine.StreamFlags(wav=str(wav), ground_truth=str(tmp_path / "labels.txt"), target_keyword="alpha",
                               detection_thresholds=[0.5])
    model = lecun_init_(KWSTransferModel(_tiny_trunk(), 3), 0).eval()
    profiling.clear()
    with _profiled():
        if stream == "float chunks":
            list(engine.stream_feature_chunks(samples / 32768.0, 16000, flags, device="cpu"))
        else:
            engine.calculate_streaming_accuracy(model, [flags], batch_size=32, verbose=False, device="cpu")
    spans = {s.name: s for s in profiling.recorded()}
    assert ("engine.cast" in spans) == (stream != "pcm16 wav")
    if stream != "float chunks":
        assert spans["engine.read_wav"].counts == {"samples": 3 * 16000, "pcm16": int(stream == "pcm16 wav")}
