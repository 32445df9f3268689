"""The port's wav2vec 2.0 trunk (``models/wav2vec2.py``) and the XLS-R
embedding model on the CPU at a tiny size: against the benchmark's plain
reference (``kwsbench/reference/wav2vec2.py``: forward, loss, every leaf's
gradient, one Adam step), against ``transformers``' ``Wav2Vec2Model`` given
the same state dict, through ``pretrain()``'s waveform path, and B0's
embedding model unchanged beside it."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kwsbench.counts import wav2vec2 as wcounts
from kwsbench.reference import train as ref_train
from kwsbench.reference import wav2vec2 as ref
from multilingual_kws_tpu_torch.data import dataset as ds_mod
from multilingual_kws_tpu_torch.models.efficientnet import EfficientNet
from multilingual_kws_tpu_torch.models.kws_model import KWSEmbeddingModel, lecun_init_, make_embedding_model
from multilingual_kws_tpu_torch.models.wav2vec2 import XLSR_300M, Wav2Vec2Config, Wav2Vec2Trunk, wav2vec2_init_
from multilingual_kws_tpu_torch.train.steps import flat_adam, sparse_ce_from_logits

# width 32, 2 layers of 4 heads, 3 x 16-channel convs, positional kernel 8
# in 4 groups: every part of the published layout at a few channels
TINY = Wav2Vec2Config(conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), hidden_size=32,
                      num_hidden_layers=2, num_attention_heads=4, intermediate_size=64, num_conv_pos_embeddings=8,
                      num_conv_pos_embedding_groups=4)
LABELS = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and small ops then spend their time in
    thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_model(seed=0):
    model = make_embedding_model(LABELS, device="cpu", trunk=Wav2Vec2Trunk(TINY))
    wav2vec2_init_(model.trunk, seed)
    lecun_init_(model.embedding_head, seed)
    lecun_init_(model.classifier, seed + 1)
    return model


def waves(b=4, n=2400, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, n, generator=g) * 3000).clamp(-32768, 32767).to(torch.int16)
    return ds_mod.normalized_waveform(x)


def frames(config, samples):
    return wcounts.conv_lengths(dataclasses.asdict(config), samples)[-1]


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_the_published_widths_are_xlsr_300ms():
    c = XLSR_300M
    assert (c.hidden_size, c.num_hidden_layers, c.num_attention_heads, c.intermediate_size) == (1024, 24, 16, 4096)
    assert c.conv_dim == (512,) * 7 and c.conv_kernel == (10, 3, 3, 3, 3, 2, 2) and c.conv_stride == (5, 2, 2, 2, 2, 2, 2)
    assert (c.num_conv_pos_embeddings, c.num_conv_pos_embedding_groups, c.layer_norm_eps) == (128, 16, 1e-5)
    assert frames(c, 16000) == 49
    with torch.device("meta"):
        model = make_embedding_model(761, device="meta", trunk=Wav2Vec2Trunk())
    assert sum(p.numel() for p in model.parameters()) == pytest.approx(318e6, rel=0.01)


def test_forward_matches_the_reference():
    model = tiny_model()
    x = waves()
    p = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cfg = dataclasses.asdict(TINY)
    assert list(p) == list(ref.spec(cfg, LABELS)) and all(p[k].shape == s for k, s in ref.spec(cfg, LABELS).items())
    with torch.no_grad():
        logits, emb = model(x, return_embedding=True)
        want = ref.Model(p, cfg)(x)
    # the same float32 operations but for the attention's softmax (written
    # out in the reference) and the dense layers' GEMM calls: a few ulps
    assert rel(logits, want) < 1e-5
    assert emb.shape == (4, 192) and model.trunk(x).shape == (4, frames(TINY, 2400), 32)


def test_loss_gradients_and_one_adam_step_match_the_reference():
    model = tiny_model(3).train()
    x, labels = waves(seed=4), torch.tensor([0, 3, 6, 2])
    p = {k: v.detach().clone() for k, v in model.state_dict().items()}
    p0 = {k: v.clone() for k, v in p.items()}
    cfg = dataclasses.asdict(TINY)
    opt = flat_adam(model.parameters(), 1e-3)
    loss = sparse_ce_from_logits(model(x), labels).mean()
    loss.backward()
    grads = {n: q.grad.clone() for n, q in model.named_parameters()}
    opt.step()
    ref_opt = ref_train.Adam(ref_train.parameter_keys(p), 1e-3)
    ref_loss, ref_grads = ref.step(ref.Model(p, cfg), p, ref_opt, x, labels)
    # the loss: one float32 sum of a few ulps' different logits
    assert abs(float(loss.detach()) - ref_loss) / ref_loss < 1e-6
    assert set(grads) == set(ref_grads)
    largest = max(float(g.abs().max()) for g in ref_grads.values())
    for k, g in grads.items():
        if k.endswith("attention.k_proj.bias"):
            # exactly zero (a key bias shifts every score of a query alike,
            # and the softmax takes no shift): both sides hold rounding, held
            # to 1e-6 of the model's largest gradient
            assert float(g.abs().max()) < 1e-6 * largest and float(ref_grads[k].abs().max()) < 1e-6 * largest
            continue
        # each leaf's gradient to 1e-4 of its largest value: the backward
        # sums over batch and frames in another order where the two sides'
        # ops differ (the softmax, the dense GEMMs)
        assert rel(g, ref_grads[k]) < 1e-4, k
    after = {k: v.detach() for k, v in model.named_parameters()}
    same = {k: v.clone() for k, v in p0.items()}
    ref_train.Adam(list(grads), 1e-3).step(same, grads)
    for k in ref_grads:
        moved, want = after[k] - p0[k], p[k] - p0[k]
        # the update rule itself: the reference's Adam on the port's own
        # gradients gives the port's parameters to 1e-5 of lr or two ulps
        # (the two round p - step differently)
        torch.testing.assert_close(after[k], same[k], rtol=2.4e-7, atol=1e-8, msg=k)
        if k.endswith("attention.k_proj.bias"):
            continue
        # from each side's gradients: Adam's first step is lr x g / (|g| +
        # eps), which divides a gradient's last-bit differences by |g|, so
        # elements of small gradient move by up to a few thousandths of lr:
        # each leaf's step to 2e-3 of its norm
        assert float((moved - want).norm() / want.norm()) < 2e-3, k


def test_the_trunk_matches_transformers_wav2vec2model():
    transformers = pytest.importorskip("transformers")
    hf_config = transformers.Wav2Vec2Config(
        **{k: v for k, v in dataclasses.asdict(TINY).items()}, num_feat_extract_layers=3, feat_extract_norm="layer",
        do_stable_layer_norm=True, feat_extract_activation="gelu", hidden_act="gelu", mask_time_prob=0.0,
        hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.Wav2Vec2Model(hf_config).eval()
    trunk = Wav2Vec2Trunk(Wav2Vec2Config.from_dict(hf_config.to_dict()))
    assert trunk.config == TINY
    trunk.load_state_dict(hf.state_dict(), strict=True)
    x = waves(seed=5)
    with torch.no_grad():
        a, b = hf(x).last_hidden_state, trunk(x)
    assert rel(b, a) < 1e-5
    # and the other way: the port's initialization loads into transformers'
    wav2vec2_init_(trunk, 7)
    hf.load_state_dict(trunk.state_dict(), strict=True)
    with torch.no_grad():
        assert rel(trunk(x), hf(x).last_hidden_state) < 1e-5


def test_normalized_waveform_is_the_feature_extractors():
    transformers = pytest.importorskip("transformers")
    g = np.random.default_rng(0)
    clips = (g.normal(size=(3, 1600)) * np.array([[10.0], [3000.0], [0.0]])).astype(np.int16)
    got = ds_mod.normalized_waveform(torch.from_numpy(clips)).numpy()
    want = transformers.Wav2Vec2FeatureExtractor.zero_mean_unit_var_norm(
        [c / 32768.0 for c in clips.astype(np.float32)], None)
    np.testing.assert_allclose(got, np.stack(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref.normalize(clips), rtol=1e-5, atol=1e-6)


def test_the_positional_conv_keeps_weight_norm():
    trunk = wav2vec2_init_(Wav2Vec2Trunk(TINY), 0)
    conv = trunk.encoder.pos_conv_embed.conv
    g, v = conv.parametrizations.weight.original0, conv.parametrizations.weight.original1
    assert g.shape == (1, 1, 8) and v.shape == (32, 8, 8)
    torch.testing.assert_close(conv.weight, v)  # initialized so that the weight is the draw
    with torch.no_grad():
        g.mul_(2.0)
    torch.testing.assert_close(conv.weight, 2.0 * v)
    names = {n for n, _ in trunk.named_parameters()}
    assert {"encoder.pos_conv_embed.conv.parametrizations.weight.original0",
            "encoder.pos_conv_embed.conv.parametrizations.weight.original1"} <= names


def test_the_trunk_records_its_spans_under_a_profiler():
    from multilingual_kws_tpu_torch.utils import profiling

    trunk = Wav2Vec2Trunk(TINY).eval()
    x = waves(b=2)
    profiling.clear()
    with torch.no_grad():
        trunk(x)
    assert profiling.recorded() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        trunk(x)
    spans = {s.name: s.counts for s in profiling.recorded()}
    profiling.clear()
    t = frames(TINY, 2400)
    assert spans == {"w2v.features": {"samples": 2400, "frames": t, "tokens": 2 * t},
                     "w2v.encoder": {"frames": t, "tokens": 2 * t}}


def test_b0s_embedding_model_gives_the_same_bits():
    """B0's pooling over H and W, its parameters and its outputs as before
    the trunks declared their pooled axes: the head's ops, written out."""
    model = lecun_init_(KWSEmbeddingModel(5, EfficientNet(width_coefficient=0.25, depth_coefficient=0.25)), 0).eval()
    assert model.trunk.takes_waveform is False and model.embedding_head.pool_dims == (-2, -1)
    x = torch.rand(3, 49, 40, 1, generator=torch.Generator().manual_seed(2)) * 26
    h = model.embedding_head
    with torch.no_grad():
        fmap = model.trunk(x)
        e = fmap.mean(dim=(-2, -1))
        e = F.relu(F.linear(e, h.dense_0.weight, h.dense_0.bias))
        e = F.relu(F.linear(e, h.dense_1.weight, h.dense_1.bias))
        e = F.selu(F.linear(e, h.dense_2.weight, h.dense_2.bias))
        logits, emb = model(x, return_embedding=True)
    assert torch.equal(emb, e) and torch.equal(logits, model.classifier(e))
    assert not any(k.startswith("embedding_head.pool") for k in model.state_dict())


def test_a_built_trunk_takes_no_trunk_arguments_and_float32_only():
    with pytest.raises(ValueError, match="no trunk arguments"):
        make_embedding_model(3, device="cpu", trunk=Wav2Vec2Trunk(TINY), width_coefficient=0.5)
    with pytest.raises(ValueError, match="float32"):
        Wav2Vec2Trunk(TINY, compute_dtype="bfloat16")


def _corpus(tmp_path):
    from kwsbench.traffic import audio

    return audio.words_corpus(tmp_path / "corpus", 9, 4, 3)


def test_the_waveform_transform_draws_the_augment_and_no_masks(tmp_path):
    from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings

    corpus = _corpus(tmp_path)
    sets = {}
    for waveform in (True, False):
        d = ds_mod.AudioDataset(standard_microspeech_model_settings(5), corpus["words"], corpus["bg_dir"], [],
                                seed=4, device="cpu", waveform=waveform)
        bank = d.build_resident_bank(corpus["train"])["bank"]
        rows, sil = torch.tensor([0, 2, 5, 1], dtype=torch.int32), torch.tensor([False, True, False, False])
        start = d.gen.get_state()
        out = d.resident_specs(bank, rows, sil)
        sets[waveform] = (d, bank, rows, sil, start, out)
    d, bank, rows, sil, start, out = sets[True]
    assert out.shape == (4, 16000) and out.dtype == torch.float32
    # the same draws and augment kernel as the feature path, then the norm
    gen = torch.Generator().manual_seed(0)
    gen.set_state(start)
    quant = ds_mod._augment_int16(d.aug_params, gen, bank, rows, sil, d.bg_data, d.bg_sizes, slice(None))
    assert torch.equal(out, ds_mod.normalized_waveform(quant))
    assert torch.equal(gen.get_state(), d.gen.get_state())  # no SpecAugment draws after
    assert not torch.equal(d.gen.get_state(), sets[False][0].gen.get_state())
    wav = torch.from_numpy(np.stack([corpus["audio"][f] for f in corpus["val"][:2]]))
    assert torch.equal(d._eval_program(wav), ds_mod.normalized_waveform(wav))


def test_one_tiny_pretrain_epoch_on_the_waveform_path(tmp_path, monkeypatch):
    from multilingual_kws_tpu_torch.train import pretrain as pretrain_mod
    from multilingual_kws_tpu_torch.train import steps
    from multilingual_kws_tpu_torch.train.checkpoints import load_metadata

    corpus = _corpus(tmp_path)
    calibrated = []
    monkeypatch.setattr(pretrain_mod, "calibrate_batch_stats", lambda *a, **k: calibrated.append(1))
    seen = []
    step = steps.make_pretrain_step

    def watching(model, optimizer, group=None):
        prog = step(model, optimizer, group)
        fn = prog[0].fn

        def spy(specs, labels, drop_generator=None):
            seen.append(tuple(specs.shape))
            return fn(specs, labels, drop_generator)

        prog[0].fn = spy
        return prog

    monkeypatch.setattr(pretrain_mod, "make_pretrain_step", watching)
    model = tiny_model(2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    config = pretrain_mod.PretrainConfig(num_labels=5, batch_size=8, num_epochs=1, steps_per_epoch=3,
                                         learning_rate=1e-3, shuffle_seed=1, checkpoint_dir=str(tmp_path / "ckpt"),
                                         device="cpu")
    m, hist, ds = pretrain_mod.pretrain(corpus["train"], corpus["val"], corpus["words"], corpus["bg_dir"],
                                        config=config, model=model, verbose=0)
    assert ds.waveform is True and seen == [(8, 16000)] * 3
    assert calibrated == []  # no BN, so no calibration and no draws for it
    assert all(np.isfinite(hist[k][0]) for k in hist) and 0.0 <= hist["val_accuracy"][0] <= 1.0
    assert any(not torch.equal(v, before[k]) for k, v in m.state_dict().items())
    meta = load_metadata(tmp_path / "ckpt")
    assert meta["trunk"] == "wav2vec2" and meta["wav2vec2"]["hidden_size"] == 32 and "width_coefficient" not in meta


def test_a_pretrained_checkpoint_rebuilds_its_wav2vec2_trunk(tmp_path):
    """``pretrain()``'s checkpoint of an XLS-R model names its trunk and
    config: ``sized_trunk`` rebuilds a ``Wav2Vec2Trunk`` of that config, whose
    embedding model takes the saved state strictly and gives the trained
    model's logits."""
    from multilingual_kws_tpu_torch.train import checkpoints as ck
    from multilingual_kws_tpu_torch.train import pretrain as pretrain_mod

    corpus = _corpus(tmp_path)
    config = pretrain_mod.PretrainConfig(num_labels=5, batch_size=8, num_epochs=1, steps_per_epoch=2,
                                         learning_rate=1e-3, shuffle_seed=1, checkpoint_dir=str(tmp_path / "ckpt"),
                                         device="cpu")
    trained, _, _ = pretrain_mod.pretrain(corpus["train"], corpus["val"], corpus["words"], corpus["bg_dir"],
                                          config=config, model=tiny_model(3), verbose=0)
    trunk = ck.sized_trunk(ck.load_metadata(tmp_path / "ckpt"))
    assert isinstance(trunk, Wav2Vec2Trunk) and trunk.config == TINY
    rebuilt = KWSEmbeddingModel(LABELS, trunk)
    rebuilt.load_state_dict(ck.load_model(tmp_path / "ckpt", device="cpu")[0], strict=True)
    x = waves()
    with torch.no_grad():
        assert torch.equal(rebuilt.eval()(x), trained(x))


@pytest.fixture(scope="module")
def xlsr_checkpoint(tmp_path_factory):
    """A tiny XLS-R embedding model saved as ``pretrain()`` saves one."""
    from multilingual_kws_tpu_torch.train import checkpoints as ck

    path = tmp_path_factory.mktemp("xlsr") / "emb"
    model = tiny_model()
    ck.save_model(path, model, {"kind": "embedding", "num_labels": LABELS, **ck.trunk_metadata(model.trunk)})
    return path


def _refusals():
    from multilingual_kws_tpu_torch.models import export_tf
    from multilingual_kws_tpu_torch.models.kws_model import KWSTransferModel
    from multilingual_kws_tpu_torch.train import checkpoints as ck
    from multilingual_kws_tpu_torch.train.finetune import transfer_learn

    features = "needs a trunk that takes \\(B, 49, 40, 1\\) features, and Wav2Vec2Trunk takes waveforms"
    return {
        "KWSTransferModel": (lambda path, out: KWSTransferModel(Wav2Vec2Trunk(TINY)), features),
        "load_transfer_model": (lambda path, out: ck.load_transfer_model(path, device="cpu"), features),
        "transfer_learn": (lambda path, out: transfer_learn("x", [], [], [], base_model_path=path, device="cpu"),
                           features),
        "convert_checkpoint_and_save": (
            lambda path, out: export_tf.convert_checkpoint_and_save(path, out / "o.keras", device="cpu"),
            "holds a Wav2Vec2Trunk trunk: the Keras model export writes is EfficientNetB0's"),
    }


@pytest.mark.parametrize("entry", ["KWSTransferModel", "load_transfer_model", "transfer_learn",
                                   "convert_checkpoint_and_save"])
def test_the_feature_paths_refuse_a_waveform_trunk(entry, xlsr_checkpoint, tmp_path, monkeypatch):
    """The fine-tune, scan, realtime and export paths take features (and the
    export writes B0's Keras layers): each refuses the XLS-R trunk, or its
    checkpoint, with a message that says so, before any training or
    TensorFlow call (TensorFlow is made unimportable here)."""
    import sys

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    call, message = _refusals()[entry]
    with pytest.raises(ValueError, match=message):
        call(xlsr_checkpoint, tmp_path)
    assert not (tmp_path / "o.keras").exists()
