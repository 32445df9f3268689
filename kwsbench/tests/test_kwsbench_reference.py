"""The plain reference against the program at tiny sizes on the CPU, and the
reference's independence from the program and from JAX."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from kwsbench.reference import augment as ref_augment
from kwsbench.reference import detector as ref_detector
from kwsbench.reference import frontend as ref_frontend
from kwsbench.reference import train as ref_train
from kwsbench.reference.model import Model, lecun_state, spec
from kwsbench.traffic import audio
from kwsbench.weights import program_model

REFERENCE = Path(__file__).resolve().parents[1] / "reference"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "multilingual_kws_tpu", "multilingual_kws_tpu_torch"}
TINY = {"width_coefficient": 0.25, "depth_coefficient": 0.25, "compute_dtype": "float32", "drop_connect_rate": 0.2,
        "top": "classifier", "num_labels": 9, "num_categories": 3}


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_neither_the_program_nor_jax(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 1, "the reference imports only its own modules relatively"
    assert not names & FORBIDDEN
    assert names <= {"__future__", "contextlib", "dataclasses", "math", "typing", "numpy", "torch"}, names


def test_exact_frontend_equals_the_programs_on_clips_and_stream_windows():
    from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch

    samples, _ = audio.stream(3, seed=11)
    fe = MicroFrontendTorch(device="cpu")
    clips = np.stack([samples[:16000], samples[8000:24000]])
    prog = fe.features_from_int16(torch.from_numpy(clips)).numpy()
    assert np.array_equal(prog, ref_frontend.clip_features(clips))
    n_w = 20
    prog = fe.stream_features(torch.from_numpy(samples[: (n_w - 1) * 320 + 16000].copy()), n_w).numpy()
    ref = np.concatenate([f for _, f in ref_frontend.stream_window_features(samples, n_w, block=8)])
    assert np.array_equal(prog, ref)


@pytest.mark.parametrize("top", ["classifier", "transfer"])
def test_reference_model_forward_matches_the_programs(top):
    st = lecun_state(spec(top, 9, 0.25, 0.25), torch.Generator().manual_seed(1), "cpu")
    model = program_model({**TINY, "top": top}, st, "cpu")
    x = torch.rand(5, 49, 40, 1, generator=torch.Generator().manual_seed(2)) * 26
    with torch.no_grad():
        # same float32 operations in the same order on the CPU: the same bits
        assert torch.equal(model(x), Model(st, top, 0.25, 0.25)(x))


def test_reference_training_step_matches_the_programs():
    from multilingual_kws_tpu_torch.train.steps import flat_adam, make_pretrain_step

    st = lecun_state(spec("classifier", 9, 0.25, 0.25), torch.Generator().manual_seed(3), "cpu")
    model = program_model(TINY, st, "cpu")
    x = torch.rand(8, 49, 40, 1, generator=torch.Generator().manual_seed(4)) * 26
    y = torch.randint(0, 9, (8,), generator=torch.Generator().manual_seed(5))
    opt = flat_adam(model.parameters(), 1e-3)
    step = make_pretrain_step(model, opt)[0].fn
    loss = float(step(x, y, torch.Generator().manual_seed(6))["loss"])
    p = {k: v.clone() for k, v in st.items()}
    ref_opt = ref_train.Adam(ref_train.parameter_keys(p), 1e-3)
    ref_loss, _ = ref_train.step(Model(p, "classifier", 0.25, 0.25), p, ref_opt, x, y, torch.Generator().manual_seed(6))
    assert ref_loss == pytest.approx(loss, rel=1e-6)
    after = dict(model.named_parameters())
    for k in ref_opt.keys:
        # Adam's update differs only in rounding (the program's bias
        # corrections are computed in another order)
        torch.testing.assert_close(after[k].detach(), p[k], rtol=1e-5, atol=1e-7)


def test_reference_detector_matches_the_programs():
    from multilingual_kws_tpu_torch.stream.detector import SingleTargetRecognizeCommands, detect_all_thresholds

    rng = np.random.default_rng(7)
    target = np.clip(np.cumsum(rng.normal(0, 0.08, 3000)) * 0.2 + 0.5, 0, 1)
    rows = np.stack([(1 - target) / 2, (1 - target) / 2, target], 1).astype(np.float32)
    times = np.arange(3000) * 20
    thresholds = [0.3, 0.5, 0.7, 0.9]
    prog = detect_all_thresholds(rows, times, thresholds, target_name="alpha")
    ref = ref_detector.detections_by_threshold(rows, times, thresholds, "alpha")
    assert any(ref.values())
    for th in thresholds:
        assert prog[th][0] == ref[th]
    live = SingleTargetRecognizeCommands(["_silence_", "_unknown_", "alpha"], 100, 0.5, 500, 4)
    found = [[lbl, int(t)] for r, t in zip(rows, times) for lbl, _, new in [live.process_latest_result(r, int(t))]
             if new and lbl == "alpha"]
    assert found == ref[0.5]


def test_reference_augment_matches_the_programs_plain_version():
    from multilingual_kws_tpu_torch.ops.augment import AugmentParams
    from multilingual_kws_tpu_torch.ops.cuda_augment import augment_quantize_plain, draw_augment_params

    rng = np.random.default_rng(8)
    clips = np.stack([audio.to_int16(audio.tone_clip(rng, (400, 900, 1500))) for _ in range(6)])
    bgs = audio.background(rng)
    sizes = torch.tensor([b.shape[0] for b in bgs])
    sil = np.array([False, True, False, False, True, False])
    prog_draws = draw_augment_params(torch.Generator().manual_seed(9), 6, 16000, sizes, AugmentParams())
    ref_draws = ref_augment.draw_augment(torch.Generator().manual_seed(9), 6, 16000, sizes)
    for k, v in ref_draws.items():
        assert torch.equal(getattr(prog_draws, k).long() if v.dtype == torch.int64 else getattr(prog_draws, k), v)
    bank = torch.from_numpy(np.stack([np.pad(b.astype(np.float32) / 32768.0, (0, 2048)) for b in bgs]))
    prog = augment_quantize_plain(torch.from_numpy(clips), torch.arange(6, dtype=torch.int32), torch.from_numpy(sil),
                                  bank, prog_draws).numpy()
    ref = ref_augment.augment_int16(clips, sil, bgs, ref_draws)
    # the RMS sums run in another order: a sample may move by one int16 step
    assert np.abs(prog.astype(int) - ref).max() <= 1 and np.mean(prog != ref) < 1e-3
