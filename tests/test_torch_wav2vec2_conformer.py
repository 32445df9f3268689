"""The port's wav2vec 2.0 Conformer trunk (``models/wav2vec2_conformer.py``)
and its embedding model on the CPU at a tiny size: against the benchmark's
plain reference (``kwsbench/reference/wav2vec2_conformer.py``: forward,
loss, every leaf's gradient, one Adam step, BatchNorm's running statistics
after two training steps), against ``transformers``'
``Wav2Vec2ConformerModel`` given the same state dict, the relative shift and
encodings, the checkpoint round trip, and ``pretrain()``'s waveform path with
no BN calibration."""

import dataclasses

import numpy as np
import pytest
import torch

from kwsbench.counts import wav2vec2 as wcounts
from kwsbench.reference import train as ref_train
from kwsbench.reference import wav2vec2_conformer as ref
from multilingual_kws_tpu_torch.data import dataset as ds_mod
from multilingual_kws_tpu_torch.models.kws_model import KWSEmbeddingModel, lecun_init_, make_embedding_model
from multilingual_kws_tpu_torch.models.wav2vec2 import wav2vec2_init_
from multilingual_kws_tpu_torch.models.wav2vec2_conformer import (CONFORMER_REL_POS_LARGE, Wav2Vec2ConformerConfig,
                                                                  Wav2Vec2ConformerTrunk, rel_shift,
                                                                  relative_encodings)
from multilingual_kws_tpu_torch.train.steps import flat_adam, sparse_ce_from_logits

# width 64, 2 blocks of 4 heads, FFN 128, depthwise kernel 7, 3 x
# 16-channel convs: every part of the published block at a few channels
TINY = Wav2Vec2ConformerConfig(conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), hidden_size=64,
                               num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
                               conv_depthwise_kernel_size=7)
LABELS = 7
SAMPLES = 4000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg():
    return {**dataclasses.asdict(TINY), "max_source_positions": 5000}


def tiny_model(seed=0):
    model = make_embedding_model(LABELS, device="cpu", trunk=Wav2Vec2ConformerTrunk(TINY))
    wav2vec2_init_(model.trunk, seed)
    lecun_init_(model.embedding_head, seed)
    lecun_init_(model.classifier, seed + 1)
    return model


def waves(b=4, n=SAMPLES, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, n, generator=g) * 3000).clamp(-32768, 32767).to(torch.int16)
    return ds_mod.normalized_waveform(x)


def frames(samples):
    return wcounts.conv_lengths(dataclasses.asdict(TINY), samples)[-1]


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def bns(model):
    return [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d)]


def test_the_published_widths_are_rel_pos_larges():
    c = CONFORMER_REL_POS_LARGE
    assert (c.hidden_size, c.num_hidden_layers, c.num_attention_heads, c.intermediate_size) == (1024, 24, 16, 4096)
    assert c.conv_depthwise_kernel_size == 31 and c.layer_norm_eps == 1e-5 and c.conv_bias is True
    assert c.conv_dim == (512,) * 7 and c.conv_kernel == (10, 3, 3, 3, 3, 2, 2) and c.conv_stride == (5, 2, 2, 2, 2, 2, 2)
    assert wcounts.conv_lengths(dataclasses.asdict(c), 16000)[-1] == 49
    with torch.device("meta"):
        model = make_embedding_model(761, device="meta", trunk=Wav2Vec2ConformerTrunk())
    trunk = sum(p.numel() for p in model.trunk.parameters())
    assert trunk == pytest.approx(610.2e6, rel=1e-3)
    assert sum(p.numel() for p in model.parameters()) == pytest.approx(612.6e6, rel=1e-3)
    assert len(bns(model)) == 24


def test_forward_matches_the_reference_in_eval_and_train_mode():
    model = tiny_model()
    with torch.no_grad():
        for bn in bns(model):  # statistics away from their identity start
            bn.running_mean.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(3))
            bn.running_var.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(4))
    x = waves()
    p = {k: v.detach().clone() for k, v in model.state_dict().items()}
    assert list(p) == list(ref.spec(cfg(), LABELS)) and all(p[k].shape == s for k, s in ref.spec(cfg(), LABELS).items())
    with torch.no_grad():
        logits, emb = model(x, return_embedding=True)
        want = ref.Model(p, cfg())(x)
        # the same float32 operations but for the written-out softmax, GLU,
        # swish and BatchNorm, the pointwise convolutions as row products and
        # the shift's view: a few ulps
        assert rel(logits, want) < 1e-5
        assert emb.shape == (4, 192) and model.trunk(x).shape == (4, frames(SAMPLES), 64)
        model.train()
        trained, want = model(x), ref.Model(p, cfg())(x, train=True)
    assert rel(trained, want) < 1e-5
    for bn, (m, v) in zip(bns(model), ref.batch_norm_keys(cfg())):
        # one train-mode forward moved both sides' statistics alike
        torch.testing.assert_close(bn.running_mean, p[m], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(bn.running_var, p[v], rtol=1e-5, atol=1e-6)
        assert int(bn.num_batches_tracked) == 1


def test_loss_gradients_adam_and_bn_statistics_match_the_reference_over_two_steps():
    model = tiny_model(3).train()
    p = {k: v.detach().clone() for k, v in model.state_dict().items()}
    p0 = {k: v.clone() for k, v in p.items()}
    opt = flat_adam(model.parameters(), 1e-3)
    ref_model, ref_opt = ref.Model(p, cfg()), ref_train.Adam(ref_train.parameter_keys(p), 1e-3)
    for step, (seed, labels) in enumerate([(4, [0, 3, 6, 2]), (5, [1, 1, 5, 4])]):
        x, labels = waves(seed=seed), torch.tensor(labels)
        opt.zero_grad(set_to_none=True)
        loss = sparse_ce_from_logits(model(x), labels).mean()
        loss.backward()
        grads = {n: q.grad.clone() for n, q in model.named_parameters()}
        opt.step()
        ref_loss, ref_grads = ref.step(ref_model, p, ref_opt, x, labels)
        if step == 0:
            assert abs(float(loss.detach()) - ref_loss) / ref_loss < 1e-6
            assert set(grads) == set(ref_grads)
            # the leaves the reference has beside XLS-R's are all there
            new = ("pos_bias_u", "pos_bias_v", "batch_norm.weight", "batch_norm.bias", "linear_pos.weight",
                   "depthwise_conv.weight", "pointwise_conv1.weight", "pointwise_conv2.weight")
            assert all(sum(k.endswith(n) for k in grads) == TINY.num_hidden_layers for n in new)
            for k, g in grads.items():
                if k.endswith("linear_k.bias"):
                    # exactly zero (a key bias shifts every score of a query
                    # alike): both sides hold rounding
                    largest = max(float(r.abs().max()) for r in ref_grads.values())
                    assert float(g.abs().max()) < 1e-6 * largest and float(ref_grads[k].abs().max()) < 1e-6 * largest
                    continue
                # each leaf to 1e-4 of its largest value: the backward sums
                # over batch and frames in another order where the two
                # sides' ops differ
                assert rel(g, ref_grads[k]) < 1e-4, k
            for k in ref_grads:
                if k.endswith("linear_k.bias"):
                    continue
                moved, want = model.state_dict()[k] - p0[k], p[k] - p0[k]
                # Adam's first step is lr x g / (|g| + eps): each leaf's step
                # to 2e-3 of its norm (test_torch_wav2vec2_trunk's bound)
                assert float((moved - want).norm() / want.norm()) < 2e-3, k
    # the running statistics after two train-mode steps: each side moved by
    # its own batches' moments (the second step's from parameters a step
    # apart by the two sides' rounding)
    for bn, (m, v) in zip(bns(model), ref.batch_norm_keys(cfg())):
        assert int(bn.num_batches_tracked) == int(p[m.replace("running_mean", "num_batches_tracked")]) == 2
        for got, want, start in ((bn.running_mean, p[m], p0[m]), (bn.running_var, p[v], p0[v])):
            assert float((got - want).norm() / (want - start).norm()) < 1e-4


def _hf_config(transformers):
    return transformers.Wav2Vec2ConformerConfig(
        **dataclasses.asdict(TINY), num_feat_extract_layers=3, feat_extract_norm="layer", do_stable_layer_norm=True,
        feat_extract_activation="gelu", hidden_act="swish", position_embeddings_type="relative", mask_time_prob=0.0,
        hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0,
        conformer_conv_dropout=0.0, layerdrop=0.0)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_the_trunk_matches_transformers_wav2vec2conformermodel(mode):
    """A strict load of ``Wav2Vec2ConformerModel``'s state dict without
    ``pos_conv_embed.*`` (built, never applied), the same hidden states in
    both modes, and the same BatchNorm statistics after a training forward."""
    transformers = pytest.importorskip("transformers")
    hf_config = _hf_config(transformers)
    torch.manual_seed(0)
    hf = transformers.Wav2Vec2ConformerModel(hf_config).eval()
    trunk = Wav2Vec2ConformerTrunk(Wav2Vec2ConformerConfig.from_dict(hf_config.to_dict()))
    assert trunk.config == TINY
    state = {k: v for k, v in hf.state_dict().items() if not k.startswith("encoder.pos_conv_embed.")}
    assert len(state) < len(hf.state_dict()) and not any("masked_spec_embed" in k for k in state)
    trunk.load_state_dict(state, strict=True)
    assert list(trunk.state_dict()) == list(state)
    x = waves(seed=5)
    hf.train(mode == "train")
    trunk.train(mode == "train")
    with torch.no_grad():
        a, b = hf(x).last_hidden_state, trunk(x)
    assert rel(b, a) < 1e-5
    for got, want in zip(bns(trunk), bns(hf)):
        torch.testing.assert_close(got.running_mean, want.running_mean, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(got.running_var, want.running_var, rtol=1e-5, atol=1e-7)
    # and the other way: the port's initialization loads into transformers'
    wav2vec2_init_(trunk, 7)
    missing, unexpected = hf.load_state_dict(trunk.state_dict(), strict=False)
    assert unexpected == [] and all(k.startswith("encoder.pos_conv_embed.") for k in missing)
    with torch.no_grad():
        assert rel(trunk.eval()(x), hf.eval()(x).last_hidden_state) < 1e-5


@pytest.mark.parametrize("t", [1, 2, 7, 8, 49])
def test_rel_shift_is_the_pad_and_view_shift(t):
    """Odd and even lengths and a single frame: the strided view equals
    ``transformers``' pad-and-view, puts relative position i - j at (i, j),
    and carries the gradient back to the scores it reads, each once."""
    g = torch.Generator().manual_seed(t)
    bd = torch.randn(2, 3, t, 2 * t - 1, generator=g, requires_grad=True)
    out = rel_shift(bd)
    assert out.shape == (2, 3, t, t)
    assert torch.equal(out, ref.shift(bd.detach()))
    i, j = torch.meshgrid(torch.arange(t), torch.arange(t), indexing="ij")
    assert torch.equal(out.detach(), bd.detach()[:, :, i, t - 1 - i + j])
    w = torch.randn(2, 3, t, t, generator=g)
    (out * w).sum().backward()
    want = torch.zeros_like(bd)
    want[:, :, i, t - 1 - i + j] = w
    assert torch.equal(bd.grad, want)


def test_relative_encodings_are_transformers_table_and_kept_per_length():
    transformers = pytest.importorskip("transformers")
    from transformers.models.wav2vec2_conformer import modeling_wav2vec2_conformer as hf_mod

    table = hf_mod.Wav2Vec2ConformerRelPositionalEmbedding(_hf_config(transformers))
    for t in (1, 6, 49):
        want = table(torch.zeros(3, t, 64))
        assert want.shape == (1, 2 * t - 1, 64) and torch.equal(relative_encodings(t, 64), want)
    # the reference's table, written apart, gives the same rows
    assert torch.equal(ref.Model({}, cfg()).positions(49, "cpu"), relative_encodings(49, 64))
    encoder = Wav2Vec2ConformerTrunk(TINY).encoder
    first = encoder.positions(12, "cpu")
    assert encoder.positions(12, "cpu") is first and encoder.positions(13, "cpu") is not first
    assert set(encoder._positions) == {(12, torch.device("cpu")), (13, torch.device("cpu"))}


def test_the_configuration_and_dtype_are_refused_where_the_trunk_cannot_compute_them():
    with pytest.raises(ValueError, match="relative positions only, not 'rotary'"):
        Wav2Vec2ConformerConfig.from_dict({"position_embeddings_type": "rotary"})
    with pytest.raises(ValueError, match="swish, not 'gelu'"):
        Wav2Vec2ConformerConfig.from_dict({"hidden_act": "gelu"})
    with pytest.raises(ValueError, match="float32"):
        Wav2Vec2ConformerTrunk(TINY, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="odd"):
        Wav2Vec2ConformerTrunk(dataclasses.replace(TINY, conv_depthwise_kernel_size=6))
    with pytest.raises(ValueError, match="no trunk arguments"):
        make_embedding_model(3, device="cpu", trunk=Wav2Vec2ConformerTrunk(TINY), width_coefficient=0.5)


def test_a_training_forward_over_several_ranks_is_refused(monkeypatch):
    from multilingual_kws_tpu_torch.parallel import mesh

    trunk = Wav2Vec2ConformerTrunk(TINY)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="BatchNorm1d normalizes one process's rows"):
        trunk.train()(waves(b=2))
    with torch.no_grad():
        assert trunk.eval()(waves(b=2)).shape == (2, frames(SAMPLES), 64)


def test_wav2vec2_init_draws_the_conformers_rule():
    a, b = Wav2Vec2ConformerTrunk(TINY), Wav2Vec2ConformerTrunk(TINY)
    with torch.no_grad():
        for bn in bns(a):
            bn.running_mean.fill_(3.0)
            bn.weight.fill_(2.0)
    wav2vec2_init_(a, 5)
    wav2vec2_init_(b, 5)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    attn = a.encoder.layers[0].self_attn
    bound = (6.0 / (4 + 16)) ** 0.5
    for bias in (attn.pos_bias_u, attn.pos_bias_v):
        assert bias.shape == (4, 16) and float(bias.detach().abs().max()) <= bound and float(bias.detach().std()) > 0.3 * bound
    assert attn.linear_pos.bias is None and abs(float(attn.linear_pos.weight.detach().std()) - 0.02) < 0.004
    conv = a.encoder.layers[0].conv_module
    assert abs(float(conv.depthwise_conv.weight.std()) - (2.0 / 7) ** 0.5) < 0.15
    assert abs(float(conv.pointwise_conv1.weight.std()) - (2.0 / 64) ** 0.5) < 0.02
    for bn in bns(a):
        assert torch.equal(bn.weight, torch.ones(64)) and torch.equal(bn.running_mean, torch.zeros(64))


def test_the_trunk_records_its_spans_under_a_profiler():
    from multilingual_kws_tpu_torch.utils import profiling

    trunk = Wav2Vec2ConformerTrunk(TINY).eval()
    x = waves(b=2)
    profiling.clear()
    with torch.no_grad():
        trunk(x)
    assert profiling.recorded() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        trunk(x)
    spans = {s.name: s.counts for s in profiling.recorded()}
    profiling.clear()
    t = frames(SAMPLES)
    assert spans == {"w2v.features": {"samples": SAMPLES, "frames": t, "tokens": 2 * t},
                     "conformer.encoder": {"frames": t, "tokens": 2 * t, "rel_positions": 2 * t - 1}}


def _corpus(tmp_path):
    from kwsbench.traffic import audio

    return audio.words_corpus(tmp_path / "corpus", 9, 4, 3)


def test_pretrain_runs_no_calibration_and_keeps_the_statistics_its_steps_moved(tmp_path, monkeypatch):
    """``pretrain()`` on the tiny Conformer: the waveform path, no BN
    calibration, BatchNorm1d in train mode in each step (its statistics moved
    once a step: ``num_batches_tracked`` counts the steps) and in eval mode
    in validation (which moves nothing), and a checkpoint that names the
    trunk."""
    from multilingual_kws_tpu_torch.train import pretrain as pretrain_mod
    from multilingual_kws_tpu_torch.train.checkpoints import load_metadata, load_model

    corpus = _corpus(tmp_path)
    calibrated, modes = [], []
    monkeypatch.setattr(pretrain_mod, "calibrate_batch_stats", lambda *a, **k: calibrated.append(1))
    model = tiny_model(2)
    model.trunk.encoder.layers[0].conv_module.batch_norm.register_forward_hook(
        lambda mod, inputs, out: modes.append(mod.training))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    config = pretrain_mod.PretrainConfig(num_labels=5, batch_size=8, num_epochs=2, steps_per_epoch=3,
                                         learning_rate=1e-3, shuffle_seed=1, checkpoint_dir=str(tmp_path / "ckpt"),
                                         device="cpu")
    m, hist, ds = pretrain_mod.pretrain(corpus["train"], corpus["val"], corpus["words"], corpus["bg_dir"],
                                        config=config, model=model, verbose=0)
    assert ds.waveform is True and calibrated == []
    # three train-mode steps, then validation's eval-mode batches, twice
    val_batches = -(-len(corpus["val"]) // 8)
    assert modes == ([True] * 3 + [False] * val_batches) * 2
    for bn in bns(m):
        assert int(bn.num_batches_tracked) == 6
        assert not torch.equal(bn.running_mean, torch.zeros(64)) and not torch.equal(bn.running_var, torch.ones(64))
    assert all(np.isfinite(hist[k]).all() for k in hist)
    assert any(not torch.equal(v, before[k]) for k, v in m.state_dict().items())
    meta = load_metadata(tmp_path / "ckpt")
    assert meta["trunk"] == "wav2vec2_conformer" and meta["wav2vec2_conformer"]["conv_depthwise_kernel_size"] == 7
    state, _ = load_model(tmp_path / "ckpt", device="cpu")
    assert any(k.endswith("batch_norm.running_var") for k in state)


def test_a_checkpoint_rebuilds_its_conformer_trunk_and_resumes(tmp_path):
    """``trunk_metadata`` -> ``save_model`` -> ``sized_trunk``: the same
    config and logits; and the CLI's ``pretrain --resume`` of the checkpoint
    trains the Conformer it holds, BN statistics included."""
    from multilingual_kws_tpu_torch.api import cli
    from multilingual_kws_tpu_torch.train import checkpoints as ck

    model = tiny_model(4)
    with torch.no_grad():
        for bn in bns(model):
            bn.running_var.fill_(1.5)
    words = ["w000", "w001", "w002", "w003"]
    ck.save_model(tmp_path / "base", model, {"kind": "embedding", "num_labels": 6, **ck.trunk_metadata(model.trunk)})
    meta = ck.load_metadata(tmp_path / "base")
    assert meta["trunk"] == "wav2vec2_conformer" and "width_coefficient" not in meta
    trunk = ck.sized_trunk(meta)
    assert isinstance(trunk, Wav2Vec2ConformerTrunk) and trunk.config == TINY
    rebuilt = KWSEmbeddingModel(LABELS, trunk)
    rebuilt.load_state_dict(ck.load_model(tmp_path / "base", device="cpu")[0], strict=True)
    x = waves()
    with torch.no_grad():
        assert torch.equal(rebuilt.eval()(x), model.eval()(x))

    corpus = _corpus(tmp_path)
    assert sorted(corpus["words"]) == words
    # the resumed model's classifier is the checkpoint's: 7 labels is
    # _silence_, _unknown_ and the commands
    (tmp_path / "commands.txt").write_text("\n".join(words[:4] + ["x", "y"][: LABELS - 6]) + "\n")
    (tmp_path / "train.txt").write_text("\n".join(corpus["train"]) + "\n")
    (tmp_path / "val.txt").write_text("\n".join(corpus["val"]) + "\n")
    (tmp_path / "unknown.txt").write_text("\n".join(corpus["val"][:2]) + "\n")
    cli.main(["pretrain", "--commands", str(tmp_path / "commands.txt"), "--train-files", str(tmp_path / "train.txt"),
              "--val-files", str(tmp_path / "val.txt"), "--unknown-files", str(tmp_path / "unknown.txt"),
              "--unknown-percentage", "10", "--background-noise", corpus["bg_dir"], "--output", str(tmp_path / "emb"),
              "--num-epochs", "1", "--steps-per-epoch", "2", "--batch-size", "8", "--resume", str(tmp_path / "base"),
              "--device", "cpu"])
    state, meta = ck.load_model(tmp_path / "emb", device="cpu")
    assert meta["trunk"] == "wav2vec2_conformer" and Wav2Vec2ConformerConfig.from_dict(meta["wav2vec2_conformer"]) == TINY
    key = "trunk.encoder.layers.0.conv_module.batch_norm."
    assert int(state[key + "num_batches_tracked"]) == 2
    # moved from the checkpoint's 1.5 by two steps at momentum 0.1
    assert not torch.equal(state[key + "running_var"], torch.full((64,), 1.5))
    assert any(not torch.equal(state[k], v) for k, v in model.state_dict().items())


@pytest.fixture(scope="module")
def conformer_checkpoint(tmp_path_factory):
    from multilingual_kws_tpu_torch.train import checkpoints as ck

    path = tmp_path_factory.mktemp("conformer") / "emb"
    model = tiny_model()
    ck.save_model(path, model, {"kind": "embedding", "num_labels": LABELS, **ck.trunk_metadata(model.trunk)})
    return path


@pytest.mark.parametrize("entry", ["KWSTransferModel", "load_transfer_model", "transfer_learn",
                                   "convert_checkpoint_and_save"])
def test_the_feature_paths_refuse_the_conformer_trunk(entry, conformer_checkpoint, tmp_path, monkeypatch):
    """The fine-tune, scan, realtime and export paths take features: each
    refuses the Conformer trunk or its checkpoint, and the transfer model's
    message names both waveform trunks."""
    import sys

    from multilingual_kws_tpu_torch.models import export_tf
    from multilingual_kws_tpu_torch.models.kws_model import KWSTransferModel
    from multilingual_kws_tpu_torch.train import checkpoints as ck
    from multilingual_kws_tpu_torch.train.finetune import transfer_learn

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    features = ("needs a trunk that takes \\(B, 49, 40, 1\\) features, and Wav2Vec2ConformerTrunk takes waveforms, "
                "as both wav2vec 2.0 trunks \\(Wav2Vec2Trunk, Wav2Vec2ConformerTrunk\\) do")
    calls = {
        "KWSTransferModel": (lambda: KWSTransferModel(Wav2Vec2ConformerTrunk(TINY)), features),
        "load_transfer_model": (lambda: ck.load_transfer_model(conformer_checkpoint, device="cpu"), features),
        "transfer_learn": (lambda: transfer_learn("x", [], [], [], base_model_path=conformer_checkpoint,
                                                  device="cpu"), features),
        "convert_checkpoint_and_save": (
            lambda: export_tf.convert_checkpoint_and_save(conformer_checkpoint, tmp_path / "o.keras", device="cpu"),
            "holds a Wav2Vec2ConformerTrunk trunk: the Keras model export writes is EfficientNetB0's"),
    }
    call, message = calls[entry]
    with pytest.raises(ValueError, match=message):
        call()
    assert not (tmp_path / "o.keras").exists()
