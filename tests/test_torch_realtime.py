"""The port's RealtimeDetector (stream/realtime.py) against the JAX
package's and against the port's offline engine, on a synthesized stream
with a narrow transfer model (width 0.25, depth 0.1) whose weights come from
the JAX package's Flax trees (models/convert.py).

Tolerances, and why: detection times are equal; confidences (the mean of
five softmax rows) within 1e-5, as the port's stream tests hold softmax rows
(the features are bit-identical, the models differ by float32 sum order).
Across chunk sizes the port's model sees other batch sizes, whose float32
sums may round differently: confidences within 1e-6 there.
"""

import jax
import numpy as np
import pytest
import torch

from helpers import keyword_clip
from multilingual_kws_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from multilingual_kws_tpu.models.kws_model import KWSTransferModel as JaxTransferModel
from multilingual_kws_tpu.ops.micro_exact import FrontendConfig as JaxFrontendConfig
from multilingual_kws_tpu.ops.micro_jax import MicroFrontendJax
from multilingual_kws_tpu.stream.realtime import RealtimeDetector as JaxRealtimeDetector
from multilingual_kws_tpu.tools.stream_synth import synthesize_stream
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict
from multilingual_kws_tpu_torch.models.efficientnet import EfficientNet
from multilingual_kws_tpu_torch.models.kws_model import KWSTransferModel
from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
from multilingual_kws_tpu_torch.stream.detector import DetectorParams, detect_all_thresholds
from multilingual_kws_tpu_torch.stream.engine import StreamFlags, featurize_stream
from multilingual_kws_tpu_torch.stream.realtime import RealtimeDetector
from multilingual_kws_tpu_torch.train.steps import calibrate_batch_stats
from test_torch_checkpoints import DEPTH, WIDTH, _jax_variables

THRESHOLD = 0.5
CONF_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream_audio():
    spec = synthesize_stream(
        "alpha",
        [keyword_clip("alpha", seed=100 + i) for i in range(3)],
        [keyword_clip("charlie", seed=200 + i) for i in range(3)],
        num_targets=3, num_distractors=3, seed=7, noise_rms=0.003,
    )
    return spec.waveform


@pytest.fixture(scope="module")
def models(stream_audio):
    """(JAX predict_fn, port model): a narrow transfer model in both packages
    with the same weights. A random trunk scores every window alike, so its
    BN statistics are first calibrated to the stream's windows (the port's
    ``calibrate_batch_stats``, copied into the Flax trees), and the target
    bias raised so that the target passes 0.5 on about half of the windows."""
    variables = _jax_variables(JaxTransferModel(trunk=JaxEfficientNet(WIDTH, DEPTH), num_categories=3), seed=11)
    port = KWSTransferModel(EfficientNet(width_coefficient=WIDTH, depth_coefficient=DEPTH), 3).eval()
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    x = torch.from_numpy(featurize_stream(stream_audio, 16000, _flags(), MicroFrontendTorch(device="cpu")))[..., None]
    calibrate_batch_stats(port, [x[::2], x[1::2]], drop_generator=torch.Generator().manual_seed(0))
    for key, t in port.state_dict().items():
        path, leaf = key.rsplit(".", 1)
        if leaf in ("running_mean", "running_var"):
            node = variables["batch_stats"]
            for part in path.split("."):
                node = node[part]
            node["mean" if leaf == "running_mean" else "var"] = t.numpy().copy()
    with torch.no_grad():
        p = port(x).numpy()
    variables["params"]["transfer_head"]["out"]["bias"][2] += np.median(np.log(p[:, :2].sum(1) / p[:, 2]))
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    jax_model = JaxTransferModel(trunk=JaxEfficientNet(WIDTH, DEPTH), num_categories=3)
    apply = jax.jit(lambda x: jax_model.apply(variables, x, train=False))
    return (lambda specs: np.asarray(apply(np.asarray(specs)))), port


def _flags():
    return StreamFlags(wav="", ground_truth="", target_keyword="alpha", detection_thresholds=[THRESHOLD])


def _run(detector, audio, chunk):
    out = []
    for i in range(0, len(audio), chunk):
        out.extend(detector.feed(audio[i : i + chunk]))
    return [(d.time_ms, d.confidence) for d in out]


def _port_run(model, audio, chunk):
    return _run(RealtimeDetector("alpha", model, detection_threshold=THRESHOLD, device="cpu"), audio, chunk)


def _assert_same(got, want, tol):
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], atol=tol, rtol=0)


def test_matches_the_jax_detector(stream_audio, models):
    jax_predict, port = models
    want = _run(JaxRealtimeDetector("alpha", jax_predict, detection_threshold=THRESHOLD,
                                    frontend=MicroFrontendJax(JaxFrontendConfig())), stream_audio, 1600)
    got = _port_run(port, stream_audio, 1600)
    assert len(want) >= 2, want
    _assert_same(got, want, CONF_TOL)


def test_chunk_size_invariance(stream_audio, models):
    _, port = models
    runs = [_port_run(port, stream_audio, chunk) for chunk in (1000, 7777, len(stream_audio))]
    assert runs[0]
    for other in runs[1:]:
        _assert_same(other, runs[0], 1e-6)


def test_matches_the_offline_engine(stream_audio, models):
    """Online detections == the port's offline engine at the same threshold:
    ``featurize_stream``, the same model, ``detect_all_thresholds``."""
    _, port = models
    windows = featurize_stream(stream_audio, 16000, _flags(), MicroFrontendTorch(device="cpu"))
    with torch.no_grad():
        probs = port(torch.from_numpy(windows)[..., None]).numpy()
    times = np.arange(windows.shape[0]) * 20
    offline, _ = detect_all_thresholds(probs, times, [THRESHOLD], DetectorParams(), target_name="alpha")[THRESHOLD]
    online = _port_run(port, stream_audio, 4000)
    assert online
    assert [t for t, _ in online] == [t for _, t in offline]


class _FakeFrontend:
    """Constant features, so the reset tests need no frontend."""

    device = torch.device("cpu")

    def features(self, windows):
        return torch.zeros((windows.shape[0], 49, 40))


def _uniform_predict(specs):
    return np.full((specs.shape[0], 3), 1.0 / 3, np.float32)


def _settings(det):
    r = det.recognizer
    return (det.clip_samples, det.stride_samples, r._threshold, r._window, r._suppression, r._minimum_count)


def test_reset_preserves_constructor_settings():
    det = RealtimeDetector(
        "alpha", _uniform_predict, detection_threshold=0.7, clip_duration_ms=500, clip_stride_ms=40,
        average_window_duration_ms=200, suppression_ms=900, minimum_count=2, frontend=_FakeFrontend(),
    )
    before = _settings(det)
    det.feed(np.zeros(16000, np.float32))
    assert det.stream_position_ms > 0
    det.reset()
    assert _settings(det) == before == (8000, 640, 0.7, 200, 900, 2)
    assert det.stream_position_ms == 0


def test_reset_restarts_window_clock():
    """After reset, window times restart from 0 with the configured hop."""
    times = []
    det = RealtimeDetector("alpha", _uniform_predict, clip_duration_ms=500, clip_stride_ms=40,
                           frontend=_FakeFrontend())

    def attach_spy():
        orig = det.recognizer.process_latest_result

        def spy(p, t_ms):
            times.append(t_ms)
            return orig(p, t_ms)

        det.recognizer.process_latest_result = spy

    attach_spy()
    det.feed(np.zeros(10000, np.float32))
    first = list(times)
    assert first == [0, 40, 80, 120]
    det.reset()
    attach_spy()
    times.clear()
    det.feed(np.zeros(10000, np.float32))
    assert times == first


def test_default_frontend_is_the_ports_on_the_device(models):
    _, port = models
    det = RealtimeDetector("alpha", port, device="cpu")
    assert isinstance(det.frontend, MicroFrontendTorch) and det.frontend.device == torch.device("cpu")
    assert det.feed(np.zeros(15999, np.float32)) == [] and det._next_window_start == 0
    det.feed(np.zeros(1, np.float32))  # completes the first window
    assert det._next_window_start == det.stride_samples
