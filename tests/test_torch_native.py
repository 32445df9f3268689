"""The port's native host code (multilingual_kws_tpu_torch/native/) against
the JAX package's (multilingual_kws_tpu/native/) and the port's own exact
frontend and wav reader, following tests/test_native.py. Every comparison
is ``==``: both libraries are integer-only C++ on the same tables, and the
wav loader copies samples.

The libraries are built with g++ into the package's build directory at
first use; a concurrent first build from two processes must leave one
whole library, and a failed build must raise.
"""

import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from multilingual_kws_tpu.native import host_frontend as jax_native
from multilingual_kws_tpu.native import wavloader as jax_wavloader
from multilingual_kws_tpu_torch import native
from multilingual_kws_tpu_torch.data.dataset import AudioDataset
from multilingual_kws_tpu_torch.native import wavloader
from multilingual_kws_tpu_torch.native.host_frontend import NativeMicroFrontend
from multilingual_kws_tpu_torch.ops import _build
from multilingual_kws_tpu_torch.ops.micro_exact import FrontendConfig, MicroFrontend, to_micro_spectrogram_exact
from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
from multilingual_kws_tpu_torch.train.evaluate import featurize_files
from multilingual_kws_tpu_torch.utils.wav import read_wav_int16, write_wav

REPO = Path(__file__).resolve().parents[1]
SCALE = np.float32(10 / 256)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and small ops then spend their time in
    thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_native_private_build(tmp_path_factory):
    """The JAX package's native libraries are built into a directory of
    this module's: tests/test_native.py may build them in place at the same
    time in another worker, and that build writes its output in place."""
    build = tmp_path_factory.mktemp("jax_native_build")
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jax_native, "_microfrontend.so"), (jax_wavloader, "_wavloader.so")):
            mp.setattr(mod, "_BUILD_DIR", build)
            mp.setattr(mod, "_LIB_PATH", build / name)
        yield


@pytest.fixture(scope="module")
def frontends():
    return NativeMicroFrontend(FrontendConfig()), jax_native.NativeMicroFrontend(), MicroFrontend(FrontendConfig())


def _int16(x):
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("case", ["noise", "zeros", "full_scale", "quiet"])
def test_batch_equals_jax_native_and_exact(frontends, case):
    port, jax_fe, exact = frontends
    rng = np.random.default_rng(0)
    batch = _int16({
        "noise": rng.normal(0, 0.2, (8, 16000)) * 32768,
        "zeros": np.zeros((2, 16000)),
        "full_scale": np.full((1, 16000), 32767.0),
        "quiet": rng.normal(0, 0.001, (2, 16000)) * 32768,
    }[case])
    got = port.features_from_int16(batch)
    np.testing.assert_array_equal(got, jax_fe.features_from_int16(batch))
    np.testing.assert_array_equal(got, np.stack([exact(b).astype(np.float32) * SCALE for b in batch]))


@pytest.mark.parametrize("config", [FrontendConfig(), FrontendConfig(enable_pcan=False),
                                    FrontendConfig(enable_log=False),
                                    FrontendConfig(window_size_ms=25, window_step_ms=10, num_channels=32)],
                         ids=["default", "no_pcan", "no_log", "micro32"])
def test_configs_equal_jax_native(config):
    from multilingual_kws_tpu.ops.micro_exact import FrontendConfig as JaxConfig

    batch = _int16(np.random.default_rng(6).normal(0, 0.1, (3, 16000)) * 32768)
    jax_config = JaxConfig(**{f: getattr(config, f) for f in config.__dataclass_fields__})
    np.testing.assert_array_equal(NativeMicroFrontend(config).features_from_int16(batch),
                                  jax_native.NativeMicroFrontend(jax_config).features_from_int16(batch))


def test_single_clip_and_frame_count(frontends):
    port, jax_fe, exact = frontends
    clip = _int16(np.random.default_rng(1).normal(0, 0.1, 16000) * 32768)
    got = port.features_from_int16(clip)
    assert got.shape == (49, 40)
    assert (port.num_frames(16000), port.num_frames(480), port.num_frames(479)) == (49, 1, 0)
    np.testing.assert_array_equal(got, exact(clip).astype(np.float32) * SCALE)
    np.testing.assert_array_equal(got, jax_fe.features_from_int16(clip))


def test_float_cast_matches_exact_path(frontends):
    port, jax_fe, _ = frontends
    wav = np.random.default_rng(2).normal(0, 0.15, 16000).clip(-1, 1).astype(np.float32)
    np.testing.assert_array_equal(port.features(wav), to_micro_spectrogram_exact(wav))
    np.testing.assert_array_equal(port.features(wav), jax_fe.features(wav))


def test_stream_matches_per_window_and_jax(frontends):
    port, jax_fe, exact = frontends
    stream = _int16(np.random.default_rng(3).normal(0, 0.1, 3 * 16000) * 32768)
    nw = (len(stream) - 16000) // 320
    got = port.stream_features(stream, nw)
    ref = np.stack([exact(stream[w * 320 : w * 320 + 16000]).astype(np.float32) * SCALE for w in range(nw)])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jax_fe.stream_features(stream, nw))
    np.testing.assert_array_equal(got, MicroFrontendTorch(device="cpu").stream_features(stream, nw).numpy())
    with pytest.raises(ValueError, match="samples"):
        port.stream_features(stream, nw + 2)


def test_thread_count_invariance():
    batch = _int16(np.random.default_rng(4).normal(0, 0.2, (6, 16000)) * 32768)
    one = NativeMicroFrontend(FrontendConfig(), num_threads=1).features_from_int16(batch)
    for threads in (2, 4, 7):
        np.testing.assert_array_equal(one, NativeMicroFrontend(FrontendConfig(), num_threads=threads)
                                      .features_from_int16(batch))


def _clips(tmp_path, n, seed):
    rng = np.random.default_rng(seed)
    files = []
    for i in range(n):
        p = tmp_path / f"{i}.wav"
        write_wav(p, rng.normal(0, 0.1, 16000).clip(-1, 1).astype(np.float32))
        files.append(str(p))
    return files


def test_featurize_files_native_equals_device(tmp_path):
    files = _clips(tmp_path, 5, 5)
    native_feats = featurize_files(files, backend="native", batch_size=2)
    assert native_feats.shape == (5, 49, 40)
    np.testing.assert_array_equal(native_feats, featurize_files(files, backend="device", device="cpu"))
    assert featurize_files([], backend="native").shape == (0, 49, 40)


def _odd_wavs(tmp_path, rng):
    """Mono wavs of exact, short and long length, a 16-bit stereo wav
    (channel 0 is read) and an 8-bit wav (declined by the native reader:
    read by utils/wav.py)."""
    paths = []
    for i, n in enumerate((16000, 9000, 20000)):
        p = tmp_path / f"m{i}.wav"
        write_wav(p, rng.normal(0, 0.3, n).clip(-1, 1).astype(np.float32))
        paths.append(str(p))
    for name, width, channels, data in (
        ("stereo.wav", 2, 2, (rng.normal(0, 0.3, (500, 2)).clip(-1, 1) * 32767).astype(np.int16).tobytes()),
        ("u8.wav", 1, 1, rng.integers(0, 256, 300).astype(np.uint8).tobytes()),
    ):
        p = tmp_path / name
        with wave.open(str(p), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(width)
            w.setframerate(16000)
            w.writeframes(data)
        paths.append(str(p))
    return paths


def test_load_batch_matches_reader_and_jax(tmp_path):
    paths = _odd_wavs(tmp_path, np.random.default_rng(4))
    got = wavloader.load_batch(paths, desired_samples=16000)
    want = np.stack([read_wav_int16(p, desired_samples=16000)[0] for p in paths])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_wavloader.load_batch(paths, desired_samples=16000))
    np.testing.assert_array_equal(wavloader.load_batch(paths, 16000, num_threads=1), got)
    assert wavloader.load_batch([], 16000).shape == (0, 16000)
    assert wavloader.available()
    with pytest.raises(FileNotFoundError):
        wavloader.load_batch(paths + [str(tmp_path / "missing.wav")], 16000)


def test_load_many_uses_cache_and_matches(tmp_path):
    files = _clips(tmp_path, 6, 5)
    bg = tmp_path / "bg"
    bg.mkdir()
    write_wav(bg / "n.wav", np.random.default_rng(5).normal(0, 0.05, 32000).clip(-1, 1).astype(np.float32))
    ds = AudioDataset(standard_microspeech_model_settings(3), ["w"], bg, [], seed=0, device="cpu")
    batch = ds._load_many(files + files[:2])  # duplicates and misses
    singles = np.stack([read_wav_int16(f, desired_samples=16000)[0] for f in files + files[:2]])
    np.testing.assert_array_equal(batch, singles)
    assert set(ds._wav_cache) == set(files)
    np.testing.assert_array_equal(ds._load_many(files), singles[:6])  # all hits


BUILD = r"""
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from multilingual_kws_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[2])
from multilingual_kws_tpu_torch.native.host_frontend import NativeMicroFrontend
import numpy as np
print(float(NativeMicroFrontend().features_from_int16(np.ones(16000, np.int16)).sum()))
"""


def test_concurrent_first_build_yields_one_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(REPO), str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert outs[0][0] == outs[1][0]
    built = sorted(f.name for f in tmp_path.iterdir())
    assert built == [native.target("microfrontend").name], built


def test_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for native/src/broken.cc"):
        native.build_library("broken")
    assert not list((tmp_path / "build").iterdir())
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build_library("broken")
