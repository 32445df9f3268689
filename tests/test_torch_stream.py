"""The port's streaming engine against the JAX engine on a synthesized stream.

Both engines run the same tiny transfer model (Flax init, carried across by
``models/convert.py``) over the same wav. Features are bit-identical (the
frontend is exact), so the softmax rows differ only by float32 sum order
inside the model: held to atol 1e-5. The detections (keyword and time) of
both engines must be equal, and at least one threshold must detect
something.

The port reads a 16-bit stream as its int16 samples and hands them to the
frontend as they are; the JAX engine reads float32 and quantises back. On
every sample width and channel count both engines' rows and detections
are ``==`` under a model that is a fixed function of the features, and the
array that reaches the port's frontend is ``==`` the float round trip.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import keyword_clip, pcm_wav, tiny_transfer_model
from multilingual_kws_tpu.stream import detector as jax_detector
from multilingual_kws_tpu.stream import engine as jax_engine
from multilingual_kws_tpu.tools.stream_synth import synthesize_stream, write_stream
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict
from multilingual_kws_tpu_torch.models.efficientnet import BlockArgs, EfficientNet
from multilingual_kws_tpu_torch.models.kws_model import KWSTransferModel
from multilingual_kws_tpu_torch.ops.micro_exact import FrontendConfig
from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
from multilingual_kws_tpu_torch.stream import detector as port_detector
from multilingual_kws_tpu_torch.stream import engine as port_engine
from multilingual_kws_tpu_torch.utils.wav import read_wav, read_wav_int16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


THRESHOLDS = [0.3, 0.5, 0.7, 0.9]
BATCH = 128  # several batches and a zero-padded tail on this stream


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_stream")
    targets = [keyword_clip("alpha", seed=1000 + i) for i in range(3)]
    distractors = [keyword_clip("charlie", seed=2000 + i) for i in range(3)]
    spec = synthesize_stream(
        "alpha", targets, distractors, num_targets=3, num_distractors=3, seed=5, noise_rms=0.003
    )
    wav, labels = tmp / "stream.wav", tmp / "labels.txt"
    write_stream(spec, wav, labels)
    return str(wav), str(labels)


@pytest.fixture(scope="module")
def models(stream):
    """(jitted Flax predict_fn, port model) with the same weights. The
    target logit's bias is raised so that the target wins about half of this
    stream's windows: random weights alone never score it top, and the
    detections would be empty."""
    fm = tiny_transfer_model(input_scale=1.0)
    x = jnp.zeros((1, 49, 40, 1), jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(fm.init)(jax.random.PRNGKey(7), x))
    rng = np.random.default_rng(7)
    v = {
        "params": jax.tree_util.tree_map(
            lambda a: (a * rng.uniform(0.8, 1.5, a.shape)).astype(np.float32), v["params"]
        ),
        "batch_stats": jax.tree_util.tree_map(
            lambda a: (a + rng.uniform(0.05, 0.5, a.shape)).astype(np.float32), v["batch_stats"]
        ),
    }
    trunk = EfficientNet(
        input_scale=1.0,
        width_coefficient=0.25,
        depth_coefficient=0.4,
        blocks=(BlockArgs(3, 1, 32, 16, 1, 1), BlockArgs(3, 1, 16, 24, 6, 2), BlockArgs(5, 1, 24, 40, 6, 2)),
    )
    tm = KWSTransferModel(trunk, 3).eval()
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    audio, sr = read_wav(stream[0])
    feats = port_engine.featurize_stream(
        audio, sr, _flags(port_engine, *stream), MicroFrontendTorch(device="cpu")
    )
    with torch.no_grad():
        p = tm(torch.from_numpy(feats)[..., None]).numpy()
    v["params"]["transfer_head"]["out"]["bias"][2] += np.median(np.log(p[:, :2].max(1) / p[:, 2]))
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    predict = jax.jit(lambda specs: fm.apply(v, specs))
    return predict, tm


def _flags(module, wav, labels, **kw):
    return module.StreamFlags(
        wav=wav, ground_truth=labels, target_keyword="alpha", detection_thresholds=THRESHOLDS, **kw
    )


@pytest.fixture(scope="module")
def both_runs(stream, models):
    wav, labels = stream
    predict, tm = models
    want = jax_engine.calculate_streaming_accuracy(
        predict, [_flags(jax_engine, wav, labels)], batch_size=BATCH, verbose=False
    )
    got = port_engine.calculate_streaming_accuracy(
        tm, [_flags(port_engine, wav, labels)], batch_size=BATCH, verbose=False, device="cpu"
    )
    return want, got


def test_inferences_match_jax_engine(both_runs, stream):
    (_, want), (_, got) = both_runs
    audio, _ = read_wav(stream[0])
    assert got.shape == want.shape == (int(np.ceil((audio.shape[0] - 16000) / 320)), 3)
    assert got.shape[0] > 2 * BATCH
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_detections_match_jax_engine(both_runs):
    (want, _), (got, _) = both_runs
    want_d, got_d = want[0][1], got[0][1]
    assert list(got_d) == list(want_d) == THRESHOLDS
    for th in THRESHOLDS:
        (found, conf), (want_found, want_conf) = got_d[th], want_d[th]
        assert found == want_found, th
        assert [c[:2] for c in conf] == [c[:2] for c in want_conf], th
        # the confidences are mean scores: the softmax tolerance holds
        np.testing.assert_allclose([c[2] for c in conf], [c[2] for c in want_conf], atol=1e-5)
    assert any(got_d[th][0] for th in THRESHOLDS), "no threshold detected anything"


def test_detector_copy_matches_jax_on_same_inferences(both_runs):
    (_, want), _ = both_runs
    times = np.arange(want.shape[0], dtype=np.int64) * 20
    a = port_detector.detect_all_thresholds(want, times, THRESHOLDS, port_detector.DetectorParams())
    b = jax_detector.detect_all_thresholds(want, times, THRESHOLDS, jax_detector.DetectorParams())
    assert a == b


def test_featurize_stream_matches_jax_and_chunking(stream):
    wav, labels = stream
    audio, sr = read_wav(wav)
    fe = MicroFrontendTorch(FrontendConfig(sample_rate=sr), device="cpu")
    got = port_engine.featurize_stream(audio, sr, _flags(port_engine, wav, labels), fe)
    want = jax_engine.featurize_stream(audio, sr, _flags(jax_engine, wav, labels))
    np.testing.assert_array_equal(got, want)
    chunked = port_engine.featurize_stream(
        audio, sr, _flags(port_engine, wav, labels, max_chunk_length_sec=3), fe
    )
    np.testing.assert_array_equal(chunked, got)


def test_eval_stream_test_memoization(stream, models, tmp_path):
    wav, labels = stream
    st = port_engine.StreamTarget(
        target_lang="syn", target_word="alpha", model_path=None,
        stream_flags=[_flags(port_engine, wav, labels)],
        destination_result_pkl=str(tmp_path / "res.pkl"),
        destination_result_inferences=str(tmp_path / "inf.npy"),
    )
    res = port_engine.eval_stream_test(st, predict_fn=models[1], verbose=False, device="cpu")
    assert "alpha" in res and (tmp_path / "res.pkl").exists() and (tmp_path / "inf.npy").exists()
    assert port_engine.eval_stream_test(st, predict_fn=models[1], device="cpu") is None
    # neither a predict_fn nor a model_path to load
    with pytest.raises(ValueError):
        port_engine.eval_stream_test(st, device="cpu")


def test_numpy_predict_fn_matches_tensor_predict_fn(both_runs, stream, models):
    """A predict_fn that returns numpy (the JAX engine's contract) gives
    the rows and detections of the model itself."""
    wav, labels = stream
    tm = models[1]

    def predict_np(specs):
        with torch.no_grad():
            return tm(specs).numpy()

    got = port_engine.calculate_streaming_accuracy(
        predict_np, [_flags(port_engine, wav, labels)], batch_size=BATCH, verbose=False, device="cpu"
    )
    want_res, want_rows = both_runs[1]
    np.testing.assert_array_equal(got[1], want_rows)
    assert got[0][0][1] == want_res[0][1]


def test_predict_batches_fixed_shape():
    seen = []

    def predict(x):
        seen.append(tuple(x.shape))
        return x[:, 0, 0, :].repeat(1, 3)

    w = torch.arange(5 * 49 * 40, dtype=torch.float32).reshape(5, 49, 40)
    out = torch.cat(port_engine._predict_batches(predict, w, 2))
    assert seen == [(2, 49, 40, 1)] * 3
    assert torch.equal(out[:, 0], w[:, 0, 0])


_PROJECTION = np.random.default_rng(11).standard_normal((49 * 40, 3)) / 200.0


def _feature_rows(specs):
    """Softmax rows that are a fixed function of each window's features
    alone, in float64 then rounded to float32, for JAX arrays and tensors
    alike: equal features give equal rows in either engine. The target's
    logit is raised so the detector has work on the test stream."""
    x = np.asarray(specs, dtype=np.float64).reshape(len(specs), -1)
    z = x @ _PROJECTION + np.array([0.0, 0.0, 4.5])
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _round_trip(path) -> np.ndarray:
    """The stream as the engine quantised it before it read int16: the float
    waveform, then the reference's clip of trunc(x * 32768)."""
    audio, _ = read_wav(path)
    return np.clip(np.trunc(audio * 32768.0), -32768, 32767).astype(np.int16)


def _recording_frontend(monkeypatch, sample_rate=16000):
    """A CPU frontend whose ``stream_features`` keeps each array it gets."""
    fe = MicroFrontendTorch(FrontendConfig(sample_rate=sample_rate), device="cpu")
    seen, original = [], fe.stream_features

    def recording(audio, num_windows):
        seen.append(audio)
        return original(audio, num_windows)

    monkeypatch.setattr(fe, "stream_features", recording)
    return fe, seen


@pytest.mark.parametrize("form", ["pcm16-mono", "pcm16-stereo", "pcm16-list-chunk", "pcm8", "pcm32"])
def test_engine_reads_every_wav_as_the_float_round_trip_did(form, stream, tmp_path, monkeypatch):
    wav, labels = str(tmp_path / f"{form}.wav"), stream[1]
    pcm_wav(wav, read_wav_int16(stream[0])[0], form)
    fe, seen = _recording_frontend(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = port_engine.calculate_streaming_accuracy(
            _feature_rows, [_flags(port_engine, wav, labels)], frontend=fe, batch_size=BATCH, verbose=False,
            device="cpu",
        )
    want = jax_engine.calculate_streaming_accuracy(
        _feature_rows, [_flags(jax_engine, wav, labels)], batch_size=BATCH, verbose=False
    )
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0][0][1] == want[0][0][1]
    assert any(got[0][0][1][th][0] for th in THRESHOLDS), "no threshold detected anything"
    (audio,) = seen
    assert audio.dtype == np.int16 and audio.flags.writeable and audio.flags.c_contiguous
    np.testing.assert_array_equal(audio, _round_trip(wav)[: audio.shape[0]])


@pytest.fixture(scope="module")
def short_stream(stream):
    """Three seconds of the stream as int16 and its float features, in two
    chunks of one second (100 windows)."""
    samples = read_wav_int16(stream[0])[0][: 3 * 16000].copy()
    flags = _flags(port_engine, *stream, max_chunk_length_sec=1)
    fe = MicroFrontendTorch(FrontendConfig(sample_rate=16000), device="cpu")
    want = port_engine.featurize_stream(samples.astype(np.float32) / 32768.0, 16000, flags, fe)
    assert want.shape == (100, 49, 40)
    return samples, flags, want


@pytest.mark.parametrize("kind", ["int16", "int16-read-only", "int16-strided", "int32", "float32"])
def test_stream_feature_chunks_take_int16_as_it_is(kind, short_stream, monkeypatch):
    """int16 audio reaches the frontend as it is (a read-only or strided
    array as a writable contiguous copy), other integer audio cast, float
    audio quantised: the same features, no warning."""
    samples, flags, want = short_stream
    audio = {
        "int16": samples.copy(),
        "int16-read-only": np.frombuffer(samples.tobytes(), np.int16),
        "int16-strided": np.repeat(samples, 2)[::2],
        "int32": samples.astype(np.int32),
        "float32": samples.astype(np.float32) / 32768.0,
    }[kind]
    fe, seen = _recording_frontend(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = np.concatenate([c.numpy() for c in port_engine.stream_feature_chunks(audio, 16000, flags, fe)])
    np.testing.assert_array_equal(got, want)
    assert len(seen) == 2
    for a in seen:
        assert a.dtype == np.int16 and a.flags.writeable and a.flags.c_contiguous
    if kind == "int16":
        assert all(np.shares_memory(a, audio) for a in seen)


@pytest.mark.parametrize("audio, error", [
    (np.full(32000, 40000, np.int32), ValueError),
    (np.zeros(32000, bool), TypeError),
])
def test_stream_feature_chunks_refuse_what_int16_cannot_hold(audio, error, short_stream):
    fe = MicroFrontendTorch(FrontendConfig(sample_rate=16000), device="cpu")
    with pytest.raises(error):
        next(port_engine.stream_feature_chunks(audio, 16000, short_stream[1], fe))
