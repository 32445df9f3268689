"""The Conformer cell (``pretrain-w2vconformer-b64``): its files found by
name, its entries in BENCHMARK.json, its counts against a sum by hand, its
driver's tiny window on the CPU, faults planted in the program caught by its
checks (a skipped BatchNorm update among them), its readers on synthetic
traces, and, on a card, its path's graphed epochs against eager steps at
full width."""

import contextlib
import json

import pytest
import torch

from kwsbench import run
from kwsbench.counts import wav2vec2_conformer as ccounts
from kwsbench.reference import wav2vec2_conformer as ref
from kwsbench.tests import conftest
from kwsbench.tests.conftest import ROOT
from kwsbench.trace import Summary

CELL = "pretrain-w2vconformer-b64"
CONFIG = "w2vconformer-embed761"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ("step_device_ms.conformer", "mfu.conformer", "dwbn_share.conformer", "idle_share.conformer")
TINY_CONFORMER = {"conv_dim": [16] * 7, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
                  "intermediate_size": 64, "conv_depthwise_kernel_size": 7, "num_labels": 9, "batch_size": 16}
TINY = {"config": TINY_CONFORMER,
        "traffic": {"words": 8, "clips": 4, "steps_per_epoch": 3, "expected_clips_per_s": 10}}
# the tests parametrized over every cell of BENCHMARK.json read these
conftest.TINY.setdefault(CELL, TINY)
conftest.SECONDS.setdefault(CELL, 1.0)


def run_tiny(seed=3, trace=False):
    return run.run_cell(CELL, seed, 1.0, trace, device="cpu", overrides=TINY)


def test_the_cells_files_are_found_by_name():
    parts = run.resolve(CELL)
    assert parts["driver"].__name__ == "kwsbench.drivers.pretrain_conformer"
    assert set(parts["readers"]) == set(READERS)
    config = parts["config"]
    assert config["reduced"] == [] and config["compute_dtype"] == "float32" and config["allow_tf32"] is False
    assert ref.dims(config) == {
        "conv_dim": [512] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
        "hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16, "intermediate_size": 4096,
        "conv_depthwise_kernel_size": 31, "max_source_positions": 5000, "layer_norm_eps": 1e-5}
    assert (config["position_embeddings_type"], config["hidden_act"], config["feat_extract_norm"]) == (
        "relative", "swish", "layer")
    assert config["conv_bias"] is True and config["do_stable_layer_norm"] is True
    assert {"hidden_act", "learning_rate", "weights", "dropout", "layerdrop", "mask_time_prob",
            "pos_conv_embed"} <= set(config["assumed"])
    wl = parts["workload"]
    assert set(wl["limit_reasons"]) == set(wl["limits"]) and "bn_stats_gap" in wl["limits"]
    assert wl["traffic"]["steps_per_epoch"] == 60 and wl["traffic"]["check_steps"] == 3


def test_benchmark_json_gains_one_configuration_one_cell_and_four_metrics():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells[CELL]["chips"] == 1 and cells[CELL]["config"] == CONFIG
    config = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
    assert config["reduced"] == [] and config["file"] == f"kwsbench/configs/{CONFIG}.json"
    assert config["source"] == "https://huggingface.co/facebook/wav2vec2-conformer-rel-pos-large/blob/main/config.json"
    rate = next(m for m in BENCH["end_to_end"] if m["name"] == "pretrain_clips_per_s")
    assert rate["workloads"][-1] == CELL
    metrics = {m["name"]: m for m in BENCH["per_layer"]}
    for name in READERS:
        assert metrics[name]["workloads"] == [CELL] and metrics[name]["moves"] == "pretrain_clips_per_s"
        assert metrics[name]["source"] == "device_trace"
    # appended at the ends of their lists
    assert [m["name"] for m in BENCH["per_layer"][-4:]] == list(READERS)
    assert BENCH["workloads"][-1]["name"] == CELL and BENCH["configs"][-1]["name"] == CONFIG


def test_training_flops_at_49_frames_are_the_sum_by_hand():
    dims = ref.dims(run.resolve(CELL)["config"])
    t, h, ff, k, b = 49, 1024, 4096, 31, 64
    encoder = [2 * n * c * cin * kk for n, c, cin, kk in zip([3199, 1599, 799, 399, 199, 99, 49], [512] * 7,
                                                             [1] + [512] * 6, [10, 3, 3, 3, 3, 2, 2])]
    block = (4 * 2 * t * h * ff + 4 * 2 * t * h * h  # two feed-forwards; q, k, v, out
             + 2 * t * t * h + 2 * t * (2 * t - 1) * h + 2 * t * t * h  # (q+u)K^T, (q+v)P^T, weights x V
             + 2 * t * h * 2 * h + 2 * t * h * k + 2 * t * h * h)  # pointwise, depthwise, pointwise
    pos = 2 * (2 * t - 1) * h * h / b  # linear_pos, once a batch of 64
    head = 2 * (h * 1024 + 1024 * 1024 + 1024 * 192 + 192 * 761)
    forward = sum(encoder) + 2 * t * 512 * h + 24 * (block + pos) + head
    assert ccounts.forward_flops(dims, 761, b) == pytest.approx(forward, rel=1e-12)
    # training: 3 x but for the first convolution's and linear_pos' input gradients
    train = 3 * forward - encoder[0] - 24 * pos
    assert ccounts.train_flops(dims, 761, b) == pytest.approx(train, rel=1e-12)
    assert ccounts.train_flops(dims, 761, b) == pytest.approx(186.79e9, rel=1e-4)
    assert ccounts.train_flops(dims, 761, b) * b == pytest.approx(11.95e12, rel=1e-3)


def test_the_reference_spec_holds_the_published_parameter_count():
    spec = ref.spec(ref.dims(run.resolve(CELL)["config"]), 761)
    stats = ("running_mean", "running_var", "num_batches_tracked")
    trunk = sum(torch.Size(s).numel() for k, s in spec.items() if k.startswith("trunk") and not k.endswith(stats))
    assert trunk == pytest.approx(610.2e6, rel=1e-3)
    assert sum(torch.Size(s).numel() for k, s in spec.items() if not k.endswith(stats)) == pytest.approx(612.6e6,
                                                                                                       rel=1e-3)
    assert not any("pos_conv_embed" in k or "masked_spec_embed" in k for k in spec)
    assert len(ref.batch_norm_keys(ref.dims(run.resolve(CELL)["config"]))) == 24


def test_a_tiny_window_on_the_cpu_is_correct_and_checks_the_statistics():
    res = run_tiny()
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"host_draw_mismatch", "wave_mismatch_share", "loss_gap", "grad_gap",
                                  "update_gap", "replay_loss_gap", "bn_stats_gap"}
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


def stale_statistics(monkeypatch):
    """BatchNorm1d moves its running statistics on a call's first step only,
    as a replayed step that skipped the update would leave them."""
    forward = torch.nn.BatchNorm1d.forward

    def first_step_only(self, x):
        if self.training and int(self.num_batches_tracked) > 0:
            self.momentum = 0.0
        return forward(self, x)

    monkeypatch.setattr(torch.nn.BatchNorm1d, "forward", first_step_only)


FAULTS = [(altered_sample, "wave_mismatch_share"), (half_batch, "loss_gap"), (no_first_moment, "replay_loss_gap"),
          (unchanged_state, "update_gap"), (stale_statistics, "bn_stats_gap")]


@pytest.mark.parametrize("fault,number", FAULTS, ids=[f.__name__ for f, _ in FAULTS])
def test_a_fault_makes_the_run_not_correct(monkeypatch, fault, number):
    fault(monkeypatch)
    res = run_tiny()
    assert res["correct"] is False
    c = res["checks"][number]
    assert not (isinstance(c["value"], float) and c["value"] <= c["limit"] if c["limit"] == 0
                else c["value"] < c["limit"]), res["checks"]


def test_the_reference_fault_of_stale_statistics_moves_only_the_statistics_gap():
    """``fault_readings``' planted reference faults, read on the CPU at the
    tiny size: the stale statistics trip ``bn_stats_gap`` alone."""
    from kwsbench.drivers import pretrain_conformer as drv

    parts = run.resolve(CELL)
    config = {**parts["config"], **TINY_CONFORMER}
    import tempfile
    from pathlib import Path

    workload = {**parts["workload"], "traffic": {**parts["workload"]["traffic"], **TINY["traffic"]}}
    with tempfile.TemporaryDirectory() as wd:
        cell = run.Cell(CELL, workload, config, 5, 1.0, False, "cpu", Path(wd), run.Spans(), run.Tracer(False))
        readings = drv.fault_readings(cell, drv.setup(cell))
    limits = workload["limits"]
    stale = readings["stale_statistics"]
    assert stale["bn_stats_gap"] > 10 * limits["bn_stats_gap"]
    assert all(stale[k] == 0.0 for k in ("loss_gap", "grad_gap", "update_gap", "replay_loss_gap"))
    assert readings["half_batch"]["loss_gap"] > limits["loss_gap"]


class _Span:
    def __init__(self, name, start, end, counts):
        self.name, self.start_ns, self.end_ns, self.counts = name, start, end, counts
        self.id, self.parent, self.call = start, None, 0


def synthetic_trace(steps=4, step_ns=1000):
    """A window of ``steps`` steps: each an augment kernel, a GEMM, a
    depthwise convolution and two BatchNorm kernels, busy 800 of its 1000 ns."""
    intervals = []
    for i in range(steps):
        t = 10_000 + i * step_ns
        intervals += [(t, t + 100, "augment_quantize_kernel"),
                      (t + 100, t + 500, "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_execute_kernel__5x_cublas"),
                      (t + 500, t + 600, "void at::native::conv_depthwise2d_forward_kernel<float>"),
                      (t + 600, t + 650, "void at::native::batch_norm_collect_statistics_kernel<float>"),
                      (t + 650, t + 800, "void at::native::batch_norm_transform_input_kernel<float>")]
    return Summary(steps * step_ns / 1e9 * 2, intervals, [(9_000, 10_000 + steps * step_ns, "pretrain")])


def readers():
    return {m: run.metric_reader(m) for m in READERS}


def counts():
    return {"steps": 4, "traced_steps": 4, "batch": 64, "dims": ref.dims(run.resolve(CELL)["config"]),
            "num_labels": 761}


def test_the_readers_on_a_synthetic_trace(monkeypatch):
    from kwsbench import program_spans

    trace = synthetic_trace()
    spans = [_Span("w2v.features", 10_010, 10_050, {"samples": 16000, "frames": 49, "tokens": 64 * 49}),
             _Span("conformer.encoder", 10_050, 10_090, {"frames": 49, "tokens": 64 * 49, "rel_positions": 97})]
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    read = readers()
    c = counts()
    assert read["step_device_ms.conformer"](trace, None, c) == pytest.approx(800e-9 * 1e3)
    assert read["dwbn_share.conformer"](trace, None, c) == pytest.approx(100 * 300 / 800)
    assert read["idle_share.conformer"](trace, None, c) == pytest.approx(100 * (1 - 3200 / 8000))
    want = ccounts.train_flops(c["dims"], 761, 64) * 4 * 64 / trace.window_s / 67e12 * 100
    assert read["mfu.conformer"](trace, None, c) == pytest.approx(want)


def test_mfu_reads_nothing_without_the_trunks_spans(monkeypatch):
    from kwsbench import program_spans

    trace = synthetic_trace()
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert readers()["mfu.conformer"](trace, None, counts()) is None
    # the XLS-R trunk's encoder span is not the Conformer's
    monkeypatch.setattr(program_spans, "recorded", lambda: [
        _Span("w2v.features", 10_010, 10_050, {"samples": 16000, "frames": 49, "tokens": 64 * 49}),
        _Span("w2v.encoder", 10_050, 10_090, {"frames": 49, "tokens": 64 * 49})])
    program_spans._LAST.clear()
    assert readers()["mfu.conformer"](trace, None, counts()) is None
    # and every reader without a trace
    assert all(r(None, None, counts()) is None for r in readers().values())


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
    """``pretrain()``'s epoch graph (forward, backward, the BatchNorm1d
    updates and Adam over the 612.6 M parameters, captured once and
    replayed) against the same steps run eagerly, from one init and seed,
    under deterministic cuDNN: the history and every tensor of the model,
    BN statistics included, bitwise."""
    from kwsbench.traffic import audio
    from kwsbench.weights_wav2vec2_conformer import conformer_state, program_model
    from multilingual_kws_tpu_torch.train import graphs
    from multilingual_kws_tpu_torch.train.pretrain import PretrainConfig, pretrain

    words = 12
    corpus = audio.words_corpus(tmp_path / "corpus", 5, words, 3)
    config = {**run.resolve(CELL)["config"], "num_labels": words + 1}
    state = conformer_state(config, 5, card)
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
    assert int(sg["trunk.encoder.layers.0.conv_module.batch_norm.num_batches_tracked"]) == 6
