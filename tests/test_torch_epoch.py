"""The port's whole-epoch programs (``train/steps.make_finetune_epoch_scan``,
``train/pretrain.build_fused_resident_epoch``, ``train/graphs.EpochGraph``)
on the CPU, where they run the captured step as a plain loop, counter and
all. On the card the same step is a CUDA graph; ``chip_smoke.py`` holds it
``==`` the eager loop there (phases e and i).

(a) A plain epoch equals the per-step loop it stands for, bitwise: every
step's loss and accuracy, every tensor of the model (BN running statistics
included), the optimizer's state and the generators' states.

(b) Against the JAX package's scanned epochs (``make_finetune_epoch_scan``,
``build_fused_resident_epoch``) from Flax-converted weights on the same
bank rows. No draw enters: no time shift, no background mix, SpecAugment
off, no silence rows, and the tiny trunk has no residual block (no
drop-connect), so both sides featurize the same int16 clips (the frontends
are bit-exact) and differ only in float32 sums. Tolerances:

- the first step's loss, rtol 1e-5: one forward pass on equal weights and
  equal features (the single-step tests' bound,
  tests/test_torch_finetune.py, tests/test_torch_pretrain.py);
- later steps' losses, rtol 1e-4, and the final trainable tensors, atol
  2 * lr * steps: the single-step tests hold gradients to rtol 1e-4 (atol
  1e-4 of a tensor's largest); Adam's first updates are +-lr whatever a
  gradient's size, so an entry whose gradient is within that rounding of
  zero may take the opposite sign on the two sides, and each step can then
  move it by up to 2 lr (the JAX package's own scanned-vs-step test names
  this effect, tests/test_pipeline.py); every other entry stays within
  1e-3 lr of a step, the Adam test's bound times ten (except the tensors
  whose exact gradient is zero, which hold rounding on both sides).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_corpus, tiny_embedding_model, tiny_transfer_model
from multilingual_kws_tpu.data.dataset import AudioDataset as JaxAudioDataset
from multilingual_kws_tpu.ops.augment import SpecAugParams as JaxSpecAugParams
from multilingual_kws_tpu.parallel import mesh as jax_mesh
from multilingual_kws_tpu.settings import standard_microspeech_model_settings as jax_settings
from multilingual_kws_tpu.train import finetune as jax_finetune
from multilingual_kws_tpu.train import pretrain as jax_pretrain
from multilingual_kws_tpu.train import steps as jax_steps
from multilingual_kws_tpu_torch.data.dataset import AudioDataset
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict
from multilingual_kws_tpu_torch.models.efficientnet import BlockArgs, EfficientNet
from multilingual_kws_tpu_torch.models.kws_model import KWSEmbeddingModel, KWSTransferModel, lecun_init_
from multilingual_kws_tpu_torch.ops import _build
from multilingual_kws_tpu_torch.ops.augment import SpecAugParams
from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
from multilingual_kws_tpu_torch.train import graphs, steps
from multilingual_kws_tpu_torch.train.finetune import _head_and_top, _head_only
from multilingual_kws_tpu_torch.train.pretrain import build_fused_resident_epoch

STEPS = 3
BATCH = 8
PHASES = {"head_only": (_head_only, jax_finetune._head_only), "head_and_top": (_head_and_top, jax_finetune._head_and_top)}


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
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"), clips_per_word=8)


def _tiny_trunk(**kw):
    """tests/helpers.py's tiny config, in the port."""
    return EfficientNet(
        width_coefficient=0.25,
        depth_coefficient=0.4,
        blocks=(BlockArgs(3, 1, 32, 16, 1, 1), BlockArgs(3, 1, 16, 24, 6, 2), BlockArgs(5, 1, 24, 40, 6, 2)),
        **kw,
    )


def _residual_trunk():
    """A narrow trunk with residual blocks and drop-connect at rate 0.5, so
    that the pretraining step draws from its drop-connect generator."""
    return EfficientNet(width_coefficient=0.25, drop_connect_rate=0.5,
                        blocks=(BlockArgs(3, 2, 32, 16, 1, 1), BlockArgs(3, 2, 16, 24, 6, 2)))


def _dataset(corpus, **kw):
    kw = {"commands": ["alpha"], "unknown_percentage": 50.0, "spec_aug_params": SpecAugParams(percentage=80),
          "seed": 3, **kw}
    return AudioDataset(standard_microspeech_model_settings(len(kw["commands"])), background_data_dir=corpus["bg_dir"],
                        unknown_files=corpus["unknown_files"], device="cpu", **kw)


def _epoch_inputs(ds, files, bank, epochs, **kw):
    """Each epoch's (steps, B) bank rows, labels and silence flags."""
    out = []
    for _ in range(epochs):
        draws = list(ds.host_train_indices(files, BATCH, STEPS, bank, **kw))
        out.append(ds._put_batch(tuple(np.stack(a) for a in zip(*draws))))
    return out


def _assert_same_training(a, b):
    """Two (model, optimizer, generators) triples hold the same bits."""
    (ma, oa, ga), (mb, ob, gb) = a, b
    for (k, t), u in zip(ma.state_dict().items(), mb.state_dict().values()):
        assert torch.equal(t, u), k
    sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k])), (i, k)
    for x, y in zip(ga, gb):
        assert torch.equal(x.get_state(), y.get_state())


@pytest.mark.parametrize("phase", list(PHASES))
def test_finetune_epoch_equals_the_step_loop(corpus, phase):
    """(a) Two epochs of the plain ``make_finetune_epoch_scan`` against the
    resident per-step loop (``make_finetune_step`` on
    ``dataset._train_device``) from the same model and seeds."""
    trainable = PHASES[phase][0]
    files = corpus["alpha"][:5]
    model = lecun_init_(KWSTransferModel(_tiny_trunk(), 3), 0).eval()
    sides = {}
    for name in ("epoch", "loop"):
        ds = _dataset(corpus)
        bank = ds.build_resident_bank(files)
        m = copy.deepcopy(model)
        inputs = _epoch_inputs(ds, files, bank, 2)
        metrics = []
        if name == "epoch":
            epoch = steps.make_finetune_epoch_scan(m, 1e-2, trainable, ds, bank["bank"], device="cpu")
            assert isinstance(epoch, graphs.EpochGraph) and epoch.graph is None
            metrics = [epoch(*batch) for batch in inputs]
            opt = epoch.optimizer
        else:
            step, _, _ = steps.make_finetune_step(m, 1e-2, trainable)
            for idx, lbl, sil in inputs:
                ms = [step(ds._train_device(bank["bank"], idx[i], sil[i]), lbl[i]) for i in range(STEPS)]
                metrics.append((torch.stack([x["loss"] for x in ms]), torch.stack([x["accuracy"] for x in ms])))
            opt = step.optimizer
        sides[name] = metrics, (m, opt, [ds.gen])
    (me, te), (ml, tl) = sides["epoch"], sides["loop"]
    for (le, ae), (ll, al) in zip(me, ml):
        assert le.shape == (STEPS,) and torch.equal(le, ll) and torch.equal(ae, al)
    _assert_same_training(te, tl)
    assert not torch.equal(te[0].state_dict()["transfer_head.out.weight"], model.state_dict()["transfer_head.out.weight"])


def test_pretrain_epoch_equals_the_step_loop(corpus):
    """(a) Two epochs of the plain ``build_fused_resident_epoch`` against
    the per-step loop of ``pretrain(scan_epoch=False)`` (``make_pretrain_step``
    on ``dataset._train_device``, drop-connect from its own generator):
    train-mode BN moves its running statistics, and a residual trunk draws
    drop-connect masks."""
    words = ["alpha", "bravo"]
    files = [f for w in words for f in corpus[w][:6]]
    labels = [w for w in words for _ in range(6)]
    model = lecun_init_(KWSEmbeddingModel(4, _residual_trunk()), 0)
    sides = {}
    for name in ("epoch", "loop"):
        ds = _dataset(corpus, commands=words, silence_percentage=10.0, unknown_percentage=15.0)
        bank = ds.build_resident_bank(files)
        m = copy.deepcopy(model)
        opt = steps.flat_adam(m.parameters(), 3e-3)
        drop = torch.Generator().manual_seed(1)
        inputs = _epoch_inputs(ds, files, bank, 2, labels=labels, single_target=False)
        if name == "epoch":
            epoch = build_fused_resident_epoch(m, opt, None, ds, bank["bank"], drop, device="cpu")
            metrics = [epoch(*batch) for batch in inputs]
        else:
            step, _ = steps.make_pretrain_step(m, opt)
            metrics = []
            for idx, lbl, sil in inputs:
                ms = [step(ds._train_device(bank["bank"], idx[i], sil[i]), lbl[i], drop) for i in range(STEPS)]
                metrics.append((torch.stack([x["loss"] for x in ms]), torch.stack([x["accuracy"] for x in ms])))
        sides[name] = metrics, (m, opt, [ds.gen, drop])
    (me, te), (ml, tl) = sides["epoch"], sides["loop"]
    for (le, ae), (ll, al) in zip(me, ml):
        assert torch.equal(le, ll) and torch.equal(ae, al)
    _assert_same_training(te, tl)
    stats = [k for k in model.state_dict() if k.endswith("running_var")]
    assert all(not torch.equal(te[0].state_dict()[k], model.state_dict()[k]) for k in stats)


def test_epoch_graph_steps_in_order_and_checks_its_inputs():
    """The plain loop takes row ``i`` of each input at step ``i`` and writes
    its metrics there; later epochs reuse the static buffers and must bring
    inputs of the same shapes, on the epoch's device."""
    seen = []

    def step(rows, labels, is_silence):
        seen.append((rows.clone(), labels.clone(), is_silence.clone()))
        return rows.sum().float(), labels.float().mean()

    epoch = graphs.EpochGraph(step, "cpu")
    idx = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    lbl = torch.arange(12, dtype=torch.int64).reshape(3, 4) % 3
    sil = torch.tensor([[True, False, False, False]] * 3)
    for _ in range(2):
        seen.clear()
        losses, accs = epoch(idx, lbl, sil)
        assert [torch.equal(r, idx[i]) and torch.equal(l, lbl[i]) and torch.equal(s, sil[i])
                for i, (r, l, s) in enumerate(seen)] == [True] * 3
        assert torch.equal(losses, idx.sum(1).float()) and torch.equal(accs, lbl.float().mean(1))
    assert epoch.replays == 0 and epoch.graph is None
    with pytest.raises(ValueError, match="every epoch"):
        epoch(idx[:2], lbl[:2], sil[:2])
    with pytest.raises(ValueError, match="runs on cpu"):
        epoch(idx.to("meta"), lbl, sil)


def test_launches_while_capturing_count_as_captured(monkeypatch):
    """A wrapper called while the stream is being captured counts the launch
    in ``captured``, not ``launches``: the graph's replays count it."""
    def wrapper():
        pass

    _build.counted(wrapper)
    try:
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        _build.count(wrapper)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        _build.count(wrapper)
        _build.count(wrapper)
        assert (wrapper.launches, wrapper.captured) == (1, 2)
    finally:
        _build.WRAPPERS.remove(wrapper)
    from multilingual_kws_tpu_torch.ops import cuda_augment, cuda_clip

    assert {cuda_augment.augment_quantize, cuda_clip.clip_features} <= set(_build.WRAPPERS)


def _quiet_datasets(corpus, commands, **kw):
    """The JAX package's and the port's datasets with no draw that moves a
    sample or a feature."""
    kw = dict(commands=commands, background_data_dir=corpus["bg_dir"], unknown_files=corpus["unknown_files"],
              time_shift_ms=0, background_frequency=0.0, background_volume_range=0.0, silence_percentage=0.0,
              seed=5, **kw)
    jds = JaxAudioDataset(model_settings=jax_settings(len(commands) + 1), spec_aug_params=JaxSpecAugParams(percentage=0),
                          **kw)
    tds = AudioDataset(standard_microspeech_model_settings(len(commands) + 1), spec_aug_params=SpecAugParams(percentage=0),
                       device="cpu", **kw)
    return jds, tds


def _moved_params(v, rng):
    return jax.tree_util.tree_map(lambda a: (a * rng.uniform(0.8, 1.5, a.shape)).astype(np.float32), v)


def _assert_trained_like_jax(model, want, names, lr, losses, want_losses, zero=()):
    """``zero``: tensors whose exact gradient is 0, which both sides hold as
    rounding: Adam turns that into +-lr updates of either sign, so only the
    2 lr a step bound applies to them."""
    np.testing.assert_allclose(losses[0], want_losses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    sd = model.state_dict()
    for k in names:
        diff = np.abs(sd[k].numpy() - want[k].numpy())
        assert diff.max() <= 2 * lr * STEPS, (k, diff.max())
        if k not in zero:
            assert (diff > 1e-3 * lr * STEPS).mean() <= 0.01, (k, (diff > 1e-3 * lr * STEPS).mean())


def test_finetune_epoch_matches_jax(corpus):
    """(b) The JAX package's scanned fine-tune epoch and the port's plain
    one, from the same Flax weights, on the same bank rows, in phase 2 (the
    head, the embedding head and the trunk's top convolution train)."""
    port_pred, jax_pred = PHASES["head_and_top"]
    lr = 1e-3
    files = corpus["alpha"][:5]
    jds, tds = _quiet_datasets(corpus, ["alpha"], unknown_percentage=50.0)
    jbank, tbank = jds.build_resident_bank(files), tds.build_resident_bank(files)
    assert jbank["index"] == tbank["index"]
    idx, lbl, sil = (np.stack(a) for a in zip(*tds.host_train_indices(files, BATCH, STEPS, tbank)))
    assert not sil.any()

    fm = tiny_transfer_model(input_scale=1.0, drop_connect_rate=0.0)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 49, 40, 1))))
    rng = np.random.default_rng(1)
    v = {"params": _moved_params(v["params"], rng),
         "batch_stats": jax.tree_util.tree_map(lambda a: (a + rng.uniform(0.05, 0.5, a.shape)).astype(np.float32),
                                               v["batch_stats"])}
    init_state, _, _, _ = jax_steps.make_finetune_step(fm, lr, jax_pred)
    epoch = jax_steps.make_finetune_epoch_scan(fm, lr, jax_pred, jds.frontend, jds.aug_params)
    keys = jax.random.split(jax.random.PRNGKey(0), STEPS)
    state, want_losses, _ = epoch(init_state(v), jbank["bank"], jds.bg_data, jds.bg_sizes, jnp.asarray(idx),
                                  jnp.asarray(lbl), jnp.asarray(sil), keys)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {"params": state.params}))

    model = KWSTransferModel(_tiny_trunk(input_scale=1.0, drop_connect_rate=0.0), 3).eval()
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    scan = steps.make_finetune_epoch_scan(model, lr, port_pred, tds, tbank["bank"], device="cpu")
    losses, _ = scan(*tds._put_batch((idx, lbl, sil)))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    _assert_trained_like_jax(model, want, names, lr, losses.numpy(), np.asarray(want_losses))


def test_pretrain_epoch_matches_jax(corpus):
    """(b) The JAX package's scanned pretraining epoch
    (``build_fused_resident_epoch`` on a one-device mesh) and the port's
    plain one, from the same Flax weights, on the same bank rows: per-step
    losses and every trained tensor."""
    lr = 1e-3
    words = ["alpha", "bravo"]
    files = [f for w in words for f in corpus[w][:6]]
    labels = [w for w in words for _ in range(6)]
    jds, tds = _quiet_datasets(corpus, words, unknown_percentage=15.0)
    jbank, tbank = jds.build_resident_bank(files), tds.build_resident_bank(files)
    assert jbank["index"] == tbank["index"]
    idx, lbl, sil = (np.stack(a) for a in zip(*tds.host_train_indices(
        files, BATCH, STEPS, tbank, labels=labels, single_target=False)))
    assert not sil.any()

    num_labels = len(tds.commands)
    fm = tiny_embedding_model(num_labels=num_labels)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 49, 40, 1))))
    rng = np.random.default_rng(1)
    v = {"params": _moved_params(v["params"], rng),
         "batch_stats": jax.tree_util.tree_map(lambda a: rng.uniform(0.01, 0.05, a.shape).astype(np.float32),
                                               v["batch_stats"])}
    mesh = jax_mesh.make_mesh(num_devices=1)
    tx = jax_steps.flat_adam(lr)
    init_fn, _, _ = jax_pretrain.build_pretrain_step(fm, tx, mesh)
    fused = jax_pretrain.build_fused_resident_epoch(fm, tx, mesh, jds)
    with mesh:
        state, _, _, m = fused(init_fn(v), jbank["bank"], jnp.asarray(idx), jnp.asarray(sil), jnp.asarray(lbl),
                               jax.random.PRNGKey(2), jax.random.PRNGKey(3))
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {"params": state.params}))

    model = KWSEmbeddingModel(num_labels, _tiny_trunk())
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    epoch = build_fused_resident_epoch(model, steps.flat_adam(model.parameters(), lr), None, tds, tbank["bank"],
                                       torch.Generator().manual_seed(0), device="cpu")
    losses, _ = epoch(*tds._put_batch((idx, lbl, sil)))
    names = [n for n, _ in model.named_parameters()]
    # each block's last BN bias reaches the loss only through train-mode BNs
    # (tests/test_torch_pretrain.py): its exact gradient is 0
    zero = {f"trunk.{b}.project_bn.bias" for b in model.trunk.block_names}
    _assert_trained_like_jax(model, want, names, lr, losses.numpy(), np.asarray(m["loss"]), zero)
