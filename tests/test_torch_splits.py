"""The port's copy of data/splits.py against the JAX package's: the same
splits, manifests and partitions on the same inputs (both are stdlib code,
so they agree exactly)."""

import numpy as np
import pytest
import torch

from multilingual_kws_tpu.data import splits as jax_splits
from multilingual_kws_tpu_torch.data import splits


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _names(n=200, seed=0):
    rng = np.random.default_rng(seed)
    words = ["yes", "no", "left", "dog", "casa"]
    return [
        f"/data/{words[i % 5]}/{rng.integers(1 << 30):08x}_nohash_{i % 3}.wav" if i % 4 else f"clip_{i}.wav"
        for i in range(n)
    ]


@pytest.mark.parametrize("pct", [(10.0, 10.0), (0.0, 0.0), (25.0, 5.0), (50.0, 50.0)])
def test_which_set_and_split_files_match_jax(pct):
    names = _names()
    assert [splits.which_set(f, *pct) for f in names] == [jax_splits.which_set(f, *pct) for f in names]
    assert splits.split_files(names, *pct) == jax_splits.split_files(names, *pct)


def test_speaker_clips_share_a_split():
    a, b = "x/abcd1234_nohash_0.wav", "y/abcd1234_nohash_7.wav"
    assert splits.which_set(a, 10, 10) == splits.which_set(b, 10, 10)


def test_read_mswc_splits_and_train_dev_test_match_jax(tmp_path):
    rows = ["SET,LINK,WORD,VALID,SPEAKER,GENDER"]
    files = []
    for i, split in enumerate(["TRAIN", "DEV", "TEST", "TRAIN", "OTHER"] * 4):
        clip = f"common_voice_xx_{i}.opus"
        rows.append(f"{split},casa/{clip},casa,True,spk{i % 3},MALE")
        files.append(f"/audio/casa/common_voice_xx_{i}.wav" if i % 2 else clip)
    csv_path = tmp_path / "splits.csv"
    csv_path.write_text("\n".join(rows) + "\n")
    got, want = splits.read_mswc_splits(csv_path), jax_splits.read_mswc_splits(csv_path)
    assert got == want and len(got) == 20
    lookup = {k.replace(".opus", ".wav"): v for k, v in got.items()}
    lookup.update(got)
    assert splits.train_dev_test("casa", files, lookup) == jax_splits.train_dev_test("casa", files, lookup)
    assert splits.MAX_NUM_WAVS_PER_CLASS == jax_splits.MAX_NUM_WAVS_PER_CLASS
