"""The engine's work after the pull: window times, the all-threshold
detector and the scoring call.

- ``detect_all_thresholds`` against a direct sequential replay (one
  ``SingleTargetRecognizeCommands`` a threshold, the JAX package's) and
  against the JAX package's detector, ``==``. The target scores lie on a
  1/64 grid, so every window average is exact in any summation order and
  can equal a threshold; hop times are uneven in some cases; some streams
  are shorter than the averaging window.
- ``window_times_ms`` ``==`` the reference's list of ``int(off * 1000 /
  sample_rate)`` at 8, 16, 44.1 and 48 kHz.
- One ``calculate_streaming_accuracy`` call: the ground truth is read once,
  every threshold is scored, a missing file raises as the JAX engine does,
  and the ``engine.detect`` / ``engine.score`` spans count the work.
"""

import numpy as np
import pytest
import torch

from multilingual_kws_tpu.stream import detector as jax_detector
from multilingual_kws_tpu.stream import engine as jax_engine
from multilingual_kws_tpu_torch.stream import detector as port_detector
from multilingual_kws_tpu_torch.stream import engine as port_engine
from multilingual_kws_tpu_torch.stream import stats as port_stats
from multilingual_kws_tpu_torch.utils import profiling
from multilingual_kws_tpu_torch.utils.wav import write_wav


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FOURTEEN = [k / 16 for k in range(2, 16)]


def _stream(seed: int, steps: int, uneven: bool):
    """(rows, times): bursty target scores on a 1/64 grid, 20 ms hops or
    uneven gaps of 1-60 ms."""
    rng = np.random.default_rng(seed)
    bursts = (rng.random(steps // 40 + 1) > 0.6).repeat(40)[:steps]
    p = np.clip(np.round((bursts * 0.8 + rng.normal(0.1, 0.25, steps)) * 64) / 64, 0, 1)
    rows = np.stack([(1 - p) / 2, (1 - p) / 2, p], axis=1).astype(np.float32)
    gaps = rng.integers(1, 61, steps) if uneven else np.full(steps, 20)
    return rows, np.cumsum(gaps).astype(np.int64)


def _replay(rows, times, threshold, params, name):
    """The reference's per-threshold replay through the online detector."""
    det = jax_detector.SingleTargetRecognizeCommands(
        ["_silence_", "_unknown_", name], params.average_window_duration_ms, threshold,
        params.suppression_ms, params.minimum_count, params.target_id)
    found = []
    for row, t in zip(rows, times):
        label, _, new = det.process_latest_result(row, int(t))
        if new and label != "_silence_":
            found.append([label, int(t)])
    return found


def _reliable_hops(times, params):
    window, n = params.average_window_duration_ms, 0
    for i, now in enumerate(times):
        start = next(j for j in range(i + 1) if times[j] >= now - window)
        n += (i - start + 1 >= params.minimum_count) and (now - times[start] >= window / 4)
    return n


CASES = [
    # seed, hops, thresholds, suppression_ms, uneven hop times
    (0, 2000, FOURTEEN, 500, False),
    (1, 2000, FOURTEEN, 500, True),
    (2, 1500, FOURTEEN, 0, False),
    (3, 1500, FOURTEEN, 0, True),
    (4, 1500, [0.5], 500, False),
    (5, 1500, [0.5], 0, True),
    (6, 1500, [0.5], 100, True),
    (7, 800, FOURTEEN, 100, True),
    (8, 3, FOURTEEN, 500, False),  # 40 ms: shorter than the 100 ms window
    (9, 5, [0.5], 500, False),
    (10, 4, FOURTEEN, 0, True),
    (11, 0, [0.5], 500, False),
    (12, 600, [0.5, 0.5, 0.25], 500, True),  # a threshold given twice
    (13, 1, [], 500, False),
    (14, 1500, FOURTEEN, -100, True),  # a reset may come on the hop after a fire
]


@pytest.mark.parametrize("seed, steps, thresholds, suppression, uneven", CASES)
def test_detector_matches_the_sequential_replay(seed, steps, thresholds, suppression, uneven):
    rows, times = _stream(seed, steps, uneven)
    params = port_detector.DetectorParams(suppression_ms=suppression)
    got = port_detector.detect_all_thresholds(rows, times, thresholds, params, target_name="alpha")
    want = jax_detector.detect_all_thresholds(
        rows, times, thresholds, jax_detector.DetectorParams(suppression_ms=suppression), target_name="alpha")
    assert got == want
    assert isinstance(got, dict) and list(got) == list(want)
    for th in thresholds:
        words, conf = got[float(th)]
        reps = thresholds.count(th)
        assert words == _replay(rows, times, th, params, "alpha") * reps
        assert type(words) is list and type(conf) is list
        assert all(type(w) is list and type(w[1]) is int for w in words)
        assert all(type(c) is list and type(c[1]) is int and type(c[2]) is float for c in conf)
    assert got.hops == _reliable_hops(times.tolist(), params)
    if steps >= 1500:
        assert sum(len(got[float(th)][0]) for th in thresholds) >= 5


def test_a_score_at_the_threshold_neither_fires_nor_resets():
    """A fire needs a score above the threshold and a reset one below: the
    plateaus at exactly 0.5 change no state, so of the three rises to 0.75
    only the first and the one after the dip to 0.25 fire (the latter one
    hop late: its window's average passes 0.5 itself on the way up)."""
    p = np.array([0.0] * 10 + [0.5] * 40 + [0.75] * 10 + [0.5] * 60 + [0.75] * 10 + [0.25] * 30 + [0.75] * 10)
    rows = np.stack([1 - p, np.zeros_like(p), p], 1)
    times = np.arange(p.shape[0]) * 20
    params = port_detector.DetectorParams()
    got = port_detector.detect_all_thresholds(rows, times, [0.5], params)
    assert got[0.5][0] == _replay(rows, times, 0.5, params, "target")
    assert [t for _, t in got[0.5][0]] == [20 * 50, 20 * 163]


@pytest.mark.parametrize("sample_rate", [8000, 16000, 44100, 48000])
@pytest.mark.parametrize("stride_ms", [10, 15, 20])
def test_window_times_match_the_reference_list(sample_rate, stride_ms):
    clip = int(1000 * sample_rate / 1000)
    stride = int(stride_ms * sample_rate / 1000)
    for seconds in (0.5, 3.7, 600):
        end = int(seconds * sample_rate) - clip
        want = [int(off * 1000 / sample_rate) for off in range(0, end, stride)]
        got = port_engine.window_times_ms(end, stride, sample_rate)
        assert got.dtype == np.int64 and got.tolist() == want


@pytest.fixture()
def short_stream(tmp_path):
    """A 4 s wav, its ground truth and seeded softmax rows of its windows."""
    rng = np.random.default_rng(11)
    wav = tmp_path / "stream.wav"
    write_wav(wav, (0.01 * rng.standard_normal(4 * 16000)).astype(np.float32))
    labels = tmp_path / "labels.txt"
    labels.write_text("alpha, 700\n_unknown_, 1500\nalpha, 1900\nalpha, 2600\n")
    rows, _ = _stream(11, int(np.ceil((4 * 16000 - 16000) / 320)), False)
    return str(wav), str(labels), rows


def _flags(module, wav, labels):
    return module.StreamFlags(wav=wav, ground_truth=labels, target_keyword="alpha",
                              detection_thresholds=[0.25, 0.5, 0.75])


def test_engine_reads_the_ground_truth_once_and_scores_every_threshold(short_stream, monkeypatch):
    wav, labels, rows = short_stream
    opened, scored = [], []
    monkeypatch.setattr(port_stats, "open", lambda path, *a: opened.append(path) or open(path, *a), raising=False)
    calculate = port_stats.StreamingAccuracyStats.calculate_accuracy_stats
    monkeypatch.setattr(port_stats.StreamingAccuracyStats, "calculate_accuracy_stats",
                        lambda self, *a: scored.append(a[0]) or calculate(self, *a))
    (flags, got), = port_engine.calculate_streaming_accuracy(
        None, [_flags(port_engine, wav, labels)], existing_inferences=rows, verbose=False, device="cpu")[0]
    (_, want), = jax_engine.calculate_streaming_accuracy(
        None, [_flags(jax_engine, wav, labels)], existing_inferences=rows, verbose=False)[0]
    assert opened == [labels]
    assert got == want and sum(len(found) for found, _ in got.values()) > 0
    assert scored == [got[th][0] for th in flags.detection_thresholds]


def test_engine_raises_on_a_missing_ground_truth_as_the_jax_engine(short_stream, tmp_path):
    wav, _, rows = short_stream
    missing = str(tmp_path / "no_labels.txt")
    with pytest.raises(FileNotFoundError):
        jax_engine.calculate_streaming_accuracy(
            None, [_flags(jax_engine, wav, missing)], existing_inferences=rows, verbose=False)
    with pytest.raises(FileNotFoundError):
        port_engine.calculate_streaming_accuracy(
            None, [_flags(port_engine, wav, missing)], existing_inferences=rows, verbose=False, device="cpu")


def test_engine_spans_count_the_work_after_the_pull(short_stream):
    wav, labels, rows = short_stream
    flags = _flags(port_engine, wav, labels)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        (_, got), = port_engine.calculate_streaming_accuracy(
            None, [flags], existing_inferences=rows, verbose=False, device="cpu")[0]
    spans = {s.name: s.counts for s in profiling.recorded()}
    times = port_engine.window_times_ms(4 * 16000 - 16000, 320, 16000)
    detections = sum(len(found) for found, _ in got.values())
    assert spans["engine.detect"] == {"hops": _reliable_hops(times.tolist(), port_detector.DetectorParams()),
                                      "detections": detections}
    assert spans["engine.score"] == {"ground_truth": 4, "found": detections}
