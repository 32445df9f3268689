"""The B0 trunk's inference epilogue (``ops/cuda_epilogue.bn_act``: eval-mode
BatchNorm, swish and the residual add in one kernel pass) and the path rule
that chooses it (``EfficientNet.inference_path``).

On the CPU: the rule, observed through a mocked card check
(``efficientnet._on_card``) and the calls the forward makes to the wrapper
(18 a float32 inference forward: the MBConv middles' expand and depthwise
BatchNorms run inside ``ops/cuda_mbconv.mbconv_middle``); the wrapper's
plain version == the module path's ops at every kind of site, float32 and
bfloat16; BatchNorm forward hooks fire on both paths (on the inference
path, those of the BatchNorms it calls: all but the middles'); the
mocked inference path's softmax against the module path's; the train-mode
pretraining step == the step of a frozen copy of the module forwards as
they were before the epilogue (so training never enters the new code).

On a card (``-m card``; run as ``python -m pytest tests/test_torch_epilogue.py
--noconftest -m card``, so that no JAX is imported): the kernel against its
twin at the scan's batch of 8192 windows at the 18 sites of a float32
inference forward (within ``chip_smoke.EPILOGUE_F32_RTOL`` of each site's
largest value) and the 49 of a bfloat16 one (==),
the transfer model's softmax against the module path, chosen by the public
rule (``chip_smoke.module_path_forward``; within
``chip_smoke.EPILOGUE_SOFTMAX_GAP``), the graphed predict
== its eager call with 18 captured launches, no cuDNN BatchNorm or layout
transpose in a traced replay, the kernel's one-value-a-thread form (odd
channel counts, unaligned tensors), and the pretraining step == the frozen
copy there too.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multilingual_kws_tpu_torch.models import efficientnet
from multilingual_kws_tpu_torch.models.efficientnet import BatchNorm, EfficientNet, correct_pad
from multilingual_kws_tpu_torch.models.kws_model import (
    lecun_init_,
    make_embedding_model,
    make_transfer_model,
    seeded_init_,
)
from multilingual_kws_tpu_torch.ops import cuda_epilogue
from multilingual_kws_tpu_torch.train.steps import flat_adam, make_pretrain_step, set_trainable

WIDTH = 0.25  # full depth: all 49 BatchNorm sites
SITES = 49
# the bn_act calls of a float32 inference forward: the stem, the 16 project
# BatchNorms and the top (the MBConv middles run in ops/cuda_mbconv)
INFERENCE_SITES = 18


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return "cuda"


def _model(device="cpu", width=WIDTH, seed=0):
    return seeded_init_(make_transfer_model(device=device, width_coefficient=width), seed)


def _specs(n=3, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, 26, (n, 49, 40, 1)).astype(np.float32)).to(device)


@contextlib.contextmanager
def _calls(monkeypatch):
    """The wrapper's calls inside the block, counted (the wrapper still runs:
    on a CPU tensor it is the plain version)."""
    calls = []
    real = cuda_epilogue.bn_act

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(cuda_epilogue, "bn_act", counting)
    yield calls


RULE_CASES = {
    # name: (train mode, trainable parameters by path, autograd context, expected)
    "eval_inference_mode": (False, None, torch.inference_mode, True),
    "eval_no_grad": (False, None, torch.no_grad, True),
    "eval_head_only_trainable": (False, lambda p: p[0] == "transfer_head", contextlib.nullcontext, True),
    "eval_everything_trainable": (False, lambda p: True, contextlib.nullcontext, False),
    "eval_top_conv_trainable": (False, lambda p: p[0] == "transfer_head" or p[:3] == ("trunk", "top", "conv"),
                                contextlib.nullcontext, False),
    "train_mode_no_grad": (True, None, torch.no_grad, False),
    "train_mode": (True, lambda p: True, contextlib.nullcontext, False),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_the_inference_path_rule(case, monkeypatch):
    train, trainable, ctx, expected = RULE_CASES[case]
    model = _model()
    if trainable is not None:
        set_trainable(model, trainable)
    model.train(train)
    x = _specs()
    gen = torch.Generator().manual_seed(0)
    with _calls(monkeypatch) as calls:
        with ctx():
            assert model.trunk.inference_path(x) is False  # a CPU tensor: never
            model(x, drop_generator=gen)
        assert calls == []
        monkeypatch.setattr(efficientnet, "_on_card", lambda x: True)
        with ctx():
            assert model.trunk.inference_path(x) is expected
            model(x, drop_generator=gen)
        assert len(calls) == (INFERENCE_SITES if expected else 0)


SITE_KINDS = {  # a site of each kind: (module path, act, residual)
    "stem": ("trunk.stem.bn", True, False),
    "expand": ("trunk.block2a.expand_bn", True, False),
    "depthwise": ("trunk.block2a.dw_bn", True, False),
    "project": ("trunk.block2a.project_bn", False, False),
    "project_residual": ("trunk.block2b.project_bn", False, True),
    "top": ("trunk.top.bn", True, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(SITE_KINDS))
def test_the_plain_version_is_the_module_ops(kind, dtype):
    """``bn_act`` on a CPU tensor == F.batch_norm -> F.silu -> + residual,
    and == the BatchNorm module's own call, at the site's shape."""
    path, act, res = SITE_KINDS[kind]
    dt = getattr(torch, dtype)
    model = _model()
    bn = model.get_submodule(path)
    shapes = {}

    def keep_shape(mod, args, out):
        shapes.setdefault("x", args[0].shape)

    hook = bn.register_forward_hook(keep_shape)
    with torch.no_grad():
        model(_specs())
    hook.remove()
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(shapes["x"], generator=g) * 2).to(dt).contiguous(memory_format=torch.channels_last)
    r = torch.randn(shapes["x"], generator=g).to(dt).contiguous(memory_format=torch.channels_last) if res else None
    stats = (bn.running_mean, bn.running_var, bn.weight, bn.bias)
    with torch.no_grad():
        want = F.batch_norm(x, *stats[:2], *stats[2:], False, 0.0, bn.eps)
        if act:
            want = F.silu(want)
        if res:
            want = want + r
        got = cuda_epilogue.bn_act(x, *stats, bn.eps, act, r)
        module = bn(x, act=act, residual=r)
    assert got.dtype == dt and torch.equal(got, want) and torch.equal(module, want)


@pytest.mark.parametrize("inference_path", [False, True])
def test_batchnorm_hooks_fire_in_an_eval_forward(inference_path, monkeypatch):
    model = _model()
    if inference_path:
        monkeypatch.setattr(efficientnet, "_on_card", lambda x: True)
    fired = []
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    handles = [bn.register_forward_hook(lambda m, a, o: fired.append(m)) for bn in bns]
    with torch.inference_mode():
        model(_specs())
    for h in handles:
        h.remove()
    middles = {id(m) for blk in model.modules() if isinstance(blk, efficientnet.MBConvBlock)
               for m in (getattr(blk, "expand_bn", None), blk.dw_bn) if m is not None}
    want = [bn for bn in bns if id(bn) not in middles] if inference_path else bns
    assert len(bns) == SITES and len(want) == (INFERENCE_SITES if inference_path else SITES) and fired == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_inference_path_keeps_the_softmax(dtype, monkeypatch):
    """The mocked inference path on the CPU (the plain epilogue; in float32
    the dense convolutions as row products, ``efficientnet.rows_conv``)
    against the module path: the convolutions' sums run in another order,
    so the softmax moves by float rounding only (float32 < 1e-6; bfloat16,
    whose convolutions are the module path's, == )."""
    model = make_transfer_model(device="cpu", width_coefficient=0.5, compute_dtype=dtype)
    seeded_init_(model, 3)
    x = _specs(4, seed=5)
    with torch.inference_mode():
        want = model(x)
        monkeypatch.setattr(efficientnet, "_on_card", lambda x: True)
        got = model(x)
    if dtype == "float32":
        assert float((got - want).abs().max()) < 1e-6
    else:
        assert torch.equal(got, want)


# --- the module forwards as they were before the inference epilogue (frozen
# copy): the train path must compute exactly these ops


def _parent_bn_forward(self, x):
    if not self.training:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    moments = torch.cat([xf.mean(dim=(0, 2, 3)), xf.square().mean(dim=(0, 2, 3))])
    mean, mean2 = moments.split(self.num_features)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    with torch.no_grad():
        m = self.momentum
        self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1.0 - m) * self.running_var + m * var)
    mul = torch.rsqrt(var + self.eps) * self.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
    return y.to(x.dtype)


def _parent_conv_forward(self, x):
    if self.stride[0] == 2:
        x = F.pad(x, correct_pad(x.shape[-2:], self.kernel_size[0]))
    bias = None if self.bias is None else self.bias.to(x.dtype)
    return self._conv_forward(x, self.weight.to(x.dtype), bias)


def _parent_conv_bn_act_forward(self, x):
    x = self.bn(self.conv(x))
    return F.silu(x) if self.use_act else x


def _parent_block_forward(self, x, drop_generator=None):
    inputs = x
    if self.args.expand_ratio != 1:
        x = F.silu(self.expand_bn(self.expand_conv(x)))
    x = F.silu(self.dw_bn(self.dw_conv(x)))
    if self.has_se:
        se = x.mean(dim=(-2, -1), keepdim=True)
        se = torch.sigmoid(self.se_expand(F.silu(self.se_reduce(se))))
        x = x * se
    x = self.project_bn(self.project_conv(x))
    if not self.residual:
        return x
    if self.training and self.drop_rate > 0:
        x = efficientnet.drop_connect(x, self.drop_rate, drop_generator)
    return x + inputs


def _parent_trunk_forward(self, x, drop_generator=None):
    x = (x * self.input_scale + self.input_bias).to(self.compute_dtype)
    x = x.permute(0, 3, 1, 2)
    x = self.stem(x)
    for name in self.block_names:
        x = getattr(self, name)(x, drop_generator)
    return self.top(x)


@contextlib.contextmanager
def _parent_forwards(monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(efficientnet.BatchNorm, "forward", _parent_bn_forward)
        m.setattr(efficientnet.Conv, "forward", _parent_conv_forward)
        m.setattr(efficientnet.ConvBnAct, "forward", _parent_conv_bn_act_forward)
        m.setattr(efficientnet.MBConvBlock, "forward", _parent_block_forward)
        m.setattr(EfficientNet, "forward", _parent_trunk_forward)
        yield


def _pretrain_step_state(device, width, batch, seed=0):
    """One train-mode pretraining step from a seeded model and batch: the
    loss and the state after it."""
    model = lecun_init_(make_embedding_model(9, device="cpu", width_coefficient=width), seed).to(device)
    step, _ = make_pretrain_step(model, flat_adam(model.parameters(), 1e-3))
    rng = np.random.default_rng(seed)
    specs = torch.from_numpy(rng.uniform(0, 26, (batch, 49, 40, 1)).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, 9, batch)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = step(specs, labels, gen)
    return out["loss"], {k: v.detach().clone() for k, v in model.state_dict().items()}


def _train_step_matches_parent(device, width, batch, monkeypatch):
    loss, state = _pretrain_step_state(device, width, batch)
    with _parent_forwards(monkeypatch):
        loss_p, state_p = _pretrain_step_state(device, width, batch)
    assert torch.equal(loss, loss_p)
    assert state.keys() == state_p.keys()
    assert all(torch.equal(state[k], state_p[k]) for k in state)


def test_the_pretraining_step_is_the_parents(monkeypatch):
    _train_step_matches_parent("cpu", WIDTH, 4, monkeypatch)


# --- on a card


@pytest.fixture
def deterministic_cudnn():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = prev


@pytest.mark.card
def test_the_pretraining_step_is_the_parents_on_the_card(card, deterministic_cudnn, monkeypatch):
    _train_step_matches_parent(card, 1.0, 64, monkeypatch)


@pytest.fixture(scope="module")
def scan_batch():
    """The full-width transfer model (seeded weights, BN calibrated on the
    card) and 8192 windows of a seeded stream through the port's exact
    frontend, as the scan batches them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    import chip_smoke
    from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
    from multilingual_kws_tpu_torch.train.steps import calibrate_batch_stats

    n = chip_smoke.EPILOGUE_BATCH
    wave, _ = chip_smoke.synth_stream((n * 320 + 16000) // 16000 + 1, seed=4)
    i16 = np.clip(np.trunc(wave * 32768.0), -32768, 32767).astype(np.int16)
    x = MicroFrontendTorch(device="cuda").stream_features(torch.from_numpy(i16).cuda(), n)[..., None]
    model = _model("cuda", width=1.0)
    calibrate_batch_stats(model, [x[:512]], drop_generator=torch.Generator(device="cuda").manual_seed(0))
    return model, x.contiguous()


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_kernel_matches_its_twin_at_every_site(card, scan_batch, dtype):
    import chip_smoke

    model, x = scan_batch
    if dtype == "bfloat16":
        model = chip_smoke.bf16_copy(torch, model)
    rows, _ = chip_smoke.epilogue_sites(torch, model, x)
    assert len(rows) == (INFERENCE_SITES if dtype == "float32" else SITES)
    worst = max(r["max_err"] / max(r["max_abs"], 1e-30) for r in rows)
    share = sum(r["differ"] for r in rows) / sum(r["values"] for r in rows)
    print(f"{dtype}: worst |kernel - twin| / largest |twin| at a site {worst:.3g}; share of values that "
          f"differ {share:.3g}")
    if dtype == "float32":
        assert worst <= chip_smoke.EPILOGUE_F32_RTOL
    else:
        assert share == 0


@pytest.mark.card
def test_the_softmax_matches_the_module_path(card, scan_batch):
    import chip_smoke
    from multilingual_kws_tpu_torch.train.graphs import eval_forward

    model, x = scan_batch
    got = eval_forward(model, x)
    want = chip_smoke.module_path_forward(torch, model, x)
    gap = float((got - want).abs().max())
    print(f"softmax, inference epilogue vs module path: {gap:.3g}")
    assert gap <= chip_smoke.EPILOGUE_SOFTMAX_GAP


@pytest.mark.card
def test_the_graphed_predict_launches_no_batchnorm_or_transpose(card, scan_batch):
    import chip_smoke
    from multilingual_kws_tpu_torch.train import graphs

    model, x = scan_batch
    model = copy.deepcopy(model)  # a program of its own
    eager = graphs.eval_forward(model, x)
    predict = graphs.serve(model, graphs.eval_forward)
    captured = cuda_epilogue.bn_act.captured
    for _ in range(2):  # an eager call, then the capture
        predict(x)
    assert cuda_epilogue.bn_act.captured - captured == INFERENCE_SITES
    assert torch.equal(predict(x), eager)
    events, _ = chip_smoke.device_trace(torch, lambda: predict(x), expect=("bn_act_kernel", INFERENCE_SITES))
    names = chip_smoke.kernel_names(events)
    assert not [n for n in names if any(k in n for k in chip_smoke.MODULE_PATH_KERNELS)], sorted(names)
    assert sum(e["cat"] == "kernel" and "bn_act_kernel" in e["name"] for e in events) >= INFERENCE_SITES


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["odd_channels", "unaligned"])
def test_the_kernel_takes_any_width_and_alignment(card, case, dtype):
    """Channels that are not a multiple of a 16-byte vector, or tensors that
    do not start on 16 bytes, take the kernel's one-value-a-thread form:
    the same arithmetic as the vector form, held to the twin as at the
    sites (float32 within ``chip_smoke.EPILOGUE_F32_RTOL`` of the largest
    value; bfloat16 ==)."""
    import chip_smoke

    dt = getattr(torch, dtype)
    shape = (3, 6, 5, 7) if case == "odd_channels" else (5, 16, 13, 10)
    n, c, h, w = shape
    g = torch.Generator().manual_seed(2)

    def tensor():
        t = (torch.randn(shape, generator=g) * 3).to(dt).contiguous(memory_format=torch.channels_last).to(card)
        if case == "unaligned":  # one value past a 16-byte boundary
            base = torch.empty(t.numel() + 1, dtype=dt, device=card)[1:]
            t = base.as_strided(shape, (h * w * c, 1, w * c, c)).copy_(t)
        return t

    x, r = tensor(), tensor()
    stats = [(torch.rand(c, generator=g) + 0.5).to(card) for _ in range(4)]
    for act in (False, True):
        got = cuda_epilogue.bn_act(x, *stats, 1e-3, act, r)
        want = cuda_epilogue.bn_act_plain(x, *stats, 1e-3, act, r)
        gap, largest = (got.float() - want.float()).abs(), float(want.float().abs().max())
        if dtype == "float32":
            assert float(gap.max()) <= chip_smoke.EPILOGUE_F32_RTOL * largest
        else:
            assert torch.equal(got, want)
