"""The port's tutorial and case study (``multilingual_kws_tpu_torch/examples``)
on the CPU: their synthetic corpus ``==`` the JAX package's test helpers'
(tests/helpers.py) on the same seeds, and both walk-throughs end to end
with tiny models and the summary keys of tests/test_tutorial.py.

The tutorial keeps the notebook's fine-tune (4 epochs of 64 steps at batch
64: the reference's steps_per_epoch = batch_size quirk), 16,384 clips
through the exact frontend's plain version: about a minute on one CPU
thread, so it is marked slow, as tests/test_tutorial.py is; phase l of
chip_smoke.py runs the tutorial at full width on the card.
"""

import zlib

import numpy as np
import pytest
import torch

import helpers
from multilingual_kws_tpu.utils.wav import read_wav
from multilingual_kws_tpu_torch.examples import case_study, synth, tutorial

SUMMARY = {"val_accuracy", "test_accuracy", "nontarget_accuracy", "embedding_dim"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("word", list(helpers.KEYWORD_SEGMENTS))
def test_keyword_clips_equal_the_helpers(word):
    assert synth.KEYWORD_SEGMENTS[word] == helpers.KEYWORD_SEGMENTS[word]
    for seed in (0, 7000, zlib.crc32(f"{word}_3".encode())):
        got, want = synth.keyword_clip(word, seed), helpers.keyword_clip(word, seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_tone_clips_equal_the_helpers():
    for freq, seed in ((400.0, 0), (1200.0, 5), (2800.0, 99)):
        assert np.array_equal(synth.tone_clip(freq, seed), helpers.tone_clip(freq, seed))


def test_corpus_equals_the_helpers(tmp_path):
    got, want = synth.make_corpus(tmp_path / "port", 3), helpers.make_corpus(tmp_path / "jax", 3)
    assert set(got) == set(want)
    for key in ("alpha", "bravo", "charlie", "unknown_files"):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            assert a.replace(str(tmp_path / "port"), "") == b.replace(str(tmp_path / "jax"), "")
            assert np.array_equal(read_wav(a)[0], read_wav(b)[0])
    assert open(got["unknown_dir"] + "/unknown_files.txt").read() == open(
        want["unknown_dir"] + "/unknown_files.txt").read()


def test_tiny_models_have_the_helpers_widths():
    emb, xfer = synth.tiny_embedding_model(4, "cpu"), synth.tiny_transfer_model("cpu")
    for model in (emb, xfer):
        assert (model.trunk.width_coefficient, model.trunk.depth_coefficient) == (0.25, 0.4)
        assert model.trunk.block_names == ["block1a", "block2a", "block3a"]
    assert emb.classifier.out_features == 4 and tuple(xfer(torch.zeros(2, 49, 40, 1)).shape) == (2, 3)


@pytest.mark.slow  # the notebook's 256-step fine-tune through the plain frontend (~1 min on one thread)
def test_tutorial_runs_end_to_end(tmp_path):
    summary = tutorial.run_tutorial(tmp_path / "tut", keyword="alpha", shots=5, tiny=True, device="cpu")
    assert set(summary) == SUMMARY
    assert summary["embedding_dim"] == 192
    assert all(0.0 <= summary[k] <= 1.0 for k in SUMMARY - {"embedding_dim"})
    assert (tmp_path / "tut" / "embedding_model" / "kws_metadata.json").exists()
    assert (tmp_path / "tut" / "embeddings.png").exists()


def test_case_study_synthetic_mode_runs_end_to_end(tmp_path):
    summary = case_study.main(["--workdir", str(tmp_path / "cs"), "--shots", "5", "--device", "cpu"])
    assert 0.0 <= summary["val_accuracy"] <= 1.0
    assert list(summary["jobs"]) == [5] and summary["jobs"][5].endswith("_target_alpha")
    (roc,) = summary["rocs"]
    assert roc["keyword"] == "alpha (5-shot)" and len(roc["thresholds"]) == len(roc["tprs"]) > 0
    assert all(0.0 <= t <= 1.0 for t in roc["tprs"])
    op = summary["operating_points"][5]
    assert op is None or op["fa_per_hour"] <= 50.0
    assert (tmp_path / "cs" / "result_5shot.pkl").exists() and (tmp_path / "cs" / "streaming_roc.png").exists()
