"""The XLS-R cell (``pretrain-xlsr300m-b64``): its files found by name, its
entries in BENCHMARK.json, its driver's tiny window on the CPU, faults
planted in the program caught by its checks, its readers on synthetic
traces, and, on a card, its path's graphed epochs against eager steps at
full width."""

import contextlib
import json

import numpy as np
import pytest
import torch

from kwsbench import run
from kwsbench.conftest import MORE_TINY
from kwsbench.counts import wav2vec2 as wcounts
from kwsbench.reference import wav2vec2 as ref
from kwsbench.tests.conftest import ROOT
from kwsbench.trace import Summary

CELL = "pretrain-xlsr300m-b64"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ("step_device_ms.xlsr", "mfu.xlsr", "conv_share.xlsr", "idle_share.xlsr")


def run_tiny(seed=3, trace=False):
    return run.run_cell(CELL, seed, 1.0, trace, device="cpu", overrides=MORE_TINY[CELL])


def test_the_cells_files_are_found_by_name():
    parts = run.resolve(CELL)
    assert parts["driver"].__name__ == "kwsbench.drivers.pretrain_xlsr"
    assert set(parts["readers"]) == set(READERS)
    config = parts["config"]
    assert config["reduced"] == [] and config["compute_dtype"] == "float32" and config["allow_tf32"] is False
    assert ref.dims(config) == {
        "conv_dim": [512] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
        "hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16, "intermediate_size": 4096,
        "num_conv_pos_embeddings": 128, "num_conv_pos_embedding_groups": 16, "layer_norm_eps": 1e-5}
    assert {"learning_rate", "weights", "dropout", "layerdrop", "mask_time_prob"} <= set(config["assumed"])


def test_benchmark_json_gains_the_cells_entries():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells[CELL]["chips"] == 1 and cells[CELL]["config"] == "xlsr300m-embed761"
    config = next(c for c in BENCH["configs"] if c["name"] == "xlsr300m-embed761")
    assert config["reduced"] == [] and config["source"].startswith("https://huggingface.co/facebook/wav2vec2-xls-r-300m")
    rate = next(m for m in BENCH["end_to_end"] if m["name"] == "pretrain_clips_per_s")
    assert rate["workloads"] == ["pretrain-b0e761-b64", CELL]
    metrics = {m["name"]: m for m in BENCH["per_layer"]}
    for name in READERS:
        assert metrics[name]["workloads"] == [CELL] and metrics[name]["moves"] == "pretrain_clips_per_s"
    # appended at the ends of their lists
    assert [m["name"] for m in BENCH["per_layer"][-4:]] == list(READERS)
    assert BENCH["workloads"][-1]["name"] == CELL and BENCH["configs"][-1]["name"] == "xlsr300m-embed761"


def test_training_flops_at_the_published_widths():
    dims = ref.dims(run.resolve(CELL)["config"])
    assert wcounts.conv_lengths(dims, 16000) == [3199, 1599, 799, 399, 199, 99, 49]
    forward = wcounts.forward_flops(dims, 761)
    assert forward == pytest.approx(35.6e9, rel=0.005)
    assert wcounts.train_flops(dims, 761) == pytest.approx(106.8e9, rel=0.005)
    assert wcounts.train_flops(dims, 761) == 3 * forward - 2 * 3199 * 512 * 10
    assert sum(int(np.prod(s)) for s in ref.spec(dims, 761).values()) == pytest.approx(318e6, rel=0.01)


def test_a_tiny_window_on_the_cpu_is_correct_and_reads_its_waveforms():
    res = run_tiny()
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"host_draw_mismatch", "wave_mismatch_share", "loss_gap", "grad_gap",
                                  "update_gap", "replay_loss_gap"}
    assert set(res["metrics"]) == {"pretrain_clips_per_s", "setup_s"} and res["attempted"] == 3
    json.dumps(res, allow_nan=False)


def altered_sample(monkeypatch):
    from kwsbench.drivers import pretrain_xlsr
    from multilingual_kws_tpu_torch.data import dataset

    monkeypatch.setattr(dataset, "augment_waveform", dataset.augment_waveform)
    pretrain_xlsr.plant_altered_sample()


def half_batch(monkeypatch):
    from multilingual_kws_tpu_torch.train import steps

    ce = steps.sparse_ce_from_logits
    monkeypatch.setattr(steps, "sparse_ce_from_logits", lambda logits, labels: ce(logits, labels)[: labels.shape[0] // 2])


def no_first_moment(monkeypatch):
    import multilingual_kws_tpu_torch.train.pretrain as pretrain

    monkeypatch.setattr(pretrain, "flat_adam", lambda params, lr: torch.optim.Adam(
        list(params), lr=lr, betas=(0.0, 0.999), eps=1e-7, foreach=True))


def unchanged_state(monkeypatch):
    import multilingual_kws_tpu_torch.train.pretrain as pretrain
    from multilingual_kws_tpu_torch.train import steps

    monkeypatch.setattr(pretrain, "flat_adam", lambda params, lr: steps.flat_adam(params, 0.0))


FAULTS = [(altered_sample, "wave_mismatch_share"), (half_batch, "loss_gap"), (no_first_moment, "replay_loss_gap"),
          (unchanged_state, "update_gap")]


@pytest.mark.parametrize("fault,number", FAULTS, ids=[f.__name__ for f, _ in FAULTS])
def test_a_fault_makes_the_run_not_correct(monkeypatch, fault, number):
    fault(monkeypatch)
    res = run_tiny()
    assert res["correct"] is False
    c = res["checks"][number]
    assert not (isinstance(c["value"], float) and c["value"] <= c["limit"] if c["limit"] == 0
                else c["value"] < c["limit"]), res["checks"]


class _Span:
    def __init__(self, name, start, end, counts):
        self.name, self.start_ns, self.end_ns, self.counts = name, start, end, counts
        self.id, self.parent, self.call = start, None, 0


def synthetic_trace(steps=4, step_ns=1000):
    """A window of ``steps`` steps: each an augment kernel, a conv kernel
    and a GEMM, busy 600 of its 1000 ns."""
    intervals = []
    for i in range(steps):
        t = 10_000 + i * step_ns
        intervals += [(t, t + 100, "augment_quantize_kernel"),
                      (t + 100, t + 300, "sm80_xmma_fprop_implicit_gemm_f32f32_nchwkcrs_execute_kernel__5x_cudnn"),
                      (t + 300, t + 600, "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_execute_kernel__5x_cublas")]
    return Summary(steps * step_ns / 1e9 * 2, intervals, [(9_000, 10_000 + steps * step_ns, "pretrain")])


def readers():
    return {m: run.metric_reader(m) for m in READERS}


def test_the_readers_on_a_synthetic_trace(monkeypatch):
    from kwsbench import program_spans

    trace = synthetic_trace()
    dims = ref.dims(run.resolve(CELL)["config"])
    counts = {"steps": 4, "traced_steps": 4, "batch": 64, "dims": dims, "num_labels": 761}
    spans = [_Span("w2v.features", 10_010, 10_050, {"samples": 16000, "frames": 49, "tokens": 64 * 49}),
             _Span("w2v.encoder", 10_050, 10_090, {"frames": 49, "tokens": 64 * 49})]
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    read = readers()
    assert read["step_device_ms.xlsr"](trace, None, counts) == pytest.approx(600e-9 * 1e3)
    assert read["conv_share.xlsr"](trace, None, counts) == pytest.approx(100 * 200 / 600)
    assert read["idle_share.xlsr"](trace, None, counts) == pytest.approx(100 * (1 - 2400 / 8000))
    want = wcounts.train_flops(dims, 761) * 4 * 64 / trace.window_s / 67e12 * 100
    assert read["mfu.xlsr"](trace, None, counts) == pytest.approx(want)


def test_mfu_reads_nothing_without_the_trunks_spans(monkeypatch):
    from kwsbench import program_spans

    trace = synthetic_trace()
    counts = {"steps": 4, "traced_steps": 4, "batch": 64, "dims": ref.dims(run.resolve(CELL)["config"]),
              "num_labels": 761}
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert readers()["mfu.xlsr"](trace, None, counts) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: [_Span("pretrain.epoch", 10_010, 10_050, {})])
    program_spans._LAST.clear()
    assert readers()["mfu.xlsr"](trace, None, counts) is None
    # and every reader without a trace
    assert all(r(None, None, counts) is None for r in readers().values())


@contextlib.contextmanager
def deterministic_cudnn():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


@pytest.mark.card
def test_graphed_epochs_equal_eager_steps_at_full_width(card, tmp_path):
    """``pretrain()``'s epoch graph (forward, backward and Adam over the
    318 M parameters, captured once and replayed) against the same steps
    run eagerly, from one init and seed, under deterministic cuDNN: the
    history, every tensor of the model and the data set's generator, bitwise."""
    from kwsbench.traffic import audio
    from kwsbench.weights_wav2vec2 import program_model, xlsr_state
    from multilingual_kws_tpu_torch.train import graphs
    from multilingual_kws_tpu_torch.train.pretrain import PretrainConfig, pretrain

    words = 12
    corpus = audio.words_corpus(tmp_path / "corpus", 5, words, 3)
    config = {**run.resolve(CELL)["config"], "num_labels": words + 1}
    state = xlsr_state(config, 5, card)
    out = {}
    with deterministic_cudnn():
        for scan in (True, False):
            model = program_model(config, state, card)
            cfg = PretrainConfig(num_labels=words + 1, batch_size=64, num_epochs=2, steps_per_epoch=3,
                                 learning_rate=1e-4, shuffle_seed=5, resident_data=True, scan_epoch=scan, device=card)
            with (contextlib.nullcontext() if scan else graphs.disable_graphs()):
                m, hist, ds = pretrain(corpus["train"], corpus["val"], corpus["words"], corpus["bg_dir"],
                                       config=cfg, model=model, verbose=0)
            out[scan] = ({k: v.detach().clone() for k, v in m.state_dict().items()}, hist, ds.gen.get_state())
            del m, model, ds
            torch.cuda.empty_cache()
    (sg, hg, gg), (se, he, ge) = out[True], out[False]
    assert hg == he
    assert torch.equal(gg, ge)
    assert all(torch.equal(sg[k], se[k]) for k in sg), [k for k in sg if not torch.equal(sg[k], se[k])][:5]
    assert any(not torch.equal(sg[k], state[k]) for k in sg)  # it trained
