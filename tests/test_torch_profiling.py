"""The port's profiling hooks (utils/profiling.py) and build cache
(utils/compilation_cache.py) against the JAX package's.

``PhaseTimer`` runs one scripted sequence of nested phases in both packages
on one scripted clock, so the counts, totals and reports must be ``==``.
``trace`` on the CPU writes a Chrome trace that holds the annotated range.
``enable_compilation_cache`` does nothing without a card, as the JAX one
does on the CPU.
"""

import itertools
import json
import time

import pytest
import torch

from multilingual_kws_tpu.utils import profiling as jax_profiling
from multilingual_kws_tpu_torch.ops import _build
from multilingual_kws_tpu_torch.utils import compilation_cache, profiling


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
    assert isinstance(profiling.global_timer(), profiling.PhaseTimer)
    assert profiling.global_timer() is profiling.global_timer()


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
