"""The middle of the B0 trunk's MBConv block (``ops/cuda_mbconv.mbconv_middle``:
expand BatchNorm and swish on load, the depthwise convolution with its zero
halo, its BatchNorm and swish, the squeeze-excitation and its gate, one
kernel on the float32 inference path) and the rule that chooses it.

On the CPU: the plain version against the module path's ops at all 16 B0
block shapes (float32, within 1e-6 of the largest value); the halo is the
activated tensor's zero; the wrapper's refusals; the forward takes the
kernel exactly on the mocked float32 inference path (16 calls, 18
``bn_act`` calls beside them) and never in train mode, in bfloat16 or with
a trainable trunk; the launch rule's forms and shapes; ``pads`` is Keras'
``correct_pad``.

On a card (``-m card``; run as ``python -m pytest tests/test_torch_mbconv.py
--noconftest -m card``, so that no JAX is imported): the kernel against its
twin at every B0 block at batch 5, 64 and 8192 in both forms (the two forms
== each other), the halo case, and a predict graph with 16 captured launches
a forward and the form each batch takes.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multilingual_kws_tpu_torch import exact_float32
from multilingual_kws_tpu_torch.models import efficientnet
from multilingual_kws_tpu_torch.models.efficientnet import MBConvBlock, correct_pad
from multilingual_kws_tpu_torch.models.kws_model import make_transfer_model, seeded_init_
from multilingual_kws_tpu_torch.ops import cuda_epilogue, cuda_mbconv
from multilingual_kws_tpu_torch.train.steps import set_trainable

BLOCKS = 16  # the B0's MBConv blocks: mbconv_middle calls a float32 inference forward
INFERENCE_SITES = 18  # bn_act calls beside them: the stem, 16 project BatchNorms, the top
SITES = 49  # the module path's BatchNorm sites
SMS = 132  # an H100's SMs
# the kernel against its twin on the card: |kernel - twin| <= this x the block's
# largest |twin|; the sums (taps, SE mean, SE products) run in other orders than
# cuDNN's and cuBLAS's (measured: 7.2e-6 at block 7a, 8192 windows)
KERNEL_RTOL = 3e-5


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


def _model(device="cpu", width=1.0, seed=0, dtype=None):
    """A seeded transfer model whose BatchNorms hold seeded statistics and
    affine parameters (so that no BatchNorm is the identity)."""
    model = seeded_init_(make_transfer_model(device="cpu", width_coefficient=width, compute_dtype=dtype), seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.5)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.weight.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.num_features, generator=g) * 0.3)
    return model.to(device).eval()


def _specs(n=2, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, 26, (n, 49, 40, 1)).astype(np.float32)).to(device)


def _blocks(model):
    return [(n, m) for n, m in model.trunk.named_children() if isinstance(m, MBConvBlock)]


def _middle_inputs(model, x):
    """Each block's middle input (the expand product's raw output, or the
    block's input) in a forward on x."""
    got, hooks = {}, []
    for name, block in _blocks(model):
        def pre(mod, args, name=name):
            y = args[0]
            got[name] = mod.expand_conv(y) if mod.args.expand_ratio != 1 else y
        hooks.append(block.register_forward_pre_hook(pre))
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return got


def _module_ops(block, x):
    """The module path between the expand and project products, as the
    forward runs it off the inference path."""
    if block.args.expand_ratio != 1:
        x = block.expand_bn(x, act=True)
    x = block.dw_bn(block.dw_conv(x), act=True)
    se = x.mean(dim=(-2, -1), keepdim=True)
    se = torch.sigmoid(block.se_expand(F.silu(block.se_reduce(se))))
    return x * se


@pytest.fixture(scope="module")
def cpu_blocks():
    model = _model()
    return model, _middle_inputs(model, _specs())


@pytest.mark.parametrize("name", [f"block{s}" for s in
                                  ("1a", "2a", "2b", "3a", "3b", "4a", "4b", "4c", "5a", "5b", "5c", "6a",
                                   "6b", "6c", "6d", "7a")])
def test_the_plain_version_is_the_module_path(name, cpu_blocks):
    """At each of the 16 B0 block shapes (k 3 and 5, stride 1 and 2,
    expand 1 and 6, odd and even H and W into correct_pad)."""
    model, inputs = cpu_blocks
    block = model.trunk.get_submodule(name)
    x = inputs[name]
    with torch.no_grad():
        want = _module_ops(block, x)
        got = cuda_mbconv.mbconv_middle(x, *block.middle_args())
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def _halo_case(device="cpu"):
    """An expanded input whose expand BatchNorm makes swish(BN(0)) large:
    bias 2 gives swish(2) = 1.76 where x = 0."""
    g = torch.Generator().manual_seed(7)
    e, se = 16, 4
    x = torch.randn(3, e, 9, 8, generator=g).contiguous(memory_format=torch.channels_last)
    ones, zeros = torch.ones(e), torch.zeros(e)
    expand = cuda_mbconv.BN(zeros, ones, ones, torch.full((e,), 2.0), 1e-3)
    dw_bn = cuda_mbconv.BN(zeros, ones, ones, zeros, 1e-3)
    se_w = cuda_mbconv.SE(torch.randn(se, e, 1, 1, generator=g), torch.randn(se, generator=g),
                          torch.randn(e, se, 1, 1, generator=g), torch.randn(e, generator=g))
    dw = torch.randn(e, 1, 3, 3, generator=g)
    to = (lambda t: t.to(device))
    return (to(x), cuda_mbconv.BN(*map(to, expand[:4]), expand.eps), to(dw), cuda_mbconv.BN(*map(to, dw_bn[:4]),
            dw_bn.eps), cuda_mbconv.SE(*map(to, se_w)))


@pytest.mark.parametrize("stride", [1, 2])
def test_the_halo_is_the_activated_tensor_s_zero(stride):
    x, expand, dw, dw_bn, se = _halo_case()
    got = cuda_mbconv.mbconv_middle(x, expand, dw, stride, dw_bn, se)
    act = F.silu(F.batch_norm(x, *expand[:4], False, 0.0, expand.eps))
    top, left, _, _ = cuda_mbconv.pads(9, 8, 3, stride)

    def rest(y):
        y = F.silu(F.batch_norm(F.conv2d(y, dw, None, stride, 0, 1, 16), *dw_bn[:4], False, 0.0, dw_bn.eps))
        s = torch.sigmoid(F.conv2d(F.silu(F.conv2d(y.mean((-2, -1), keepdim=True), se[0], se[1])), se[2], se[3]))
        return y * s

    zeros_after = rest(F.pad(act, (left, 1, top, 1)))  # the activated tensor padded with zeros
    zeros_before = rest(F.silu(F.batch_norm(F.pad(x, (left, 1, top, 1)), *expand[:4], False, 0.0, expand.eps)))
    assert float((got - zeros_after).abs().max()) <= 1e-6 * float(zeros_after.abs().max())
    assert float((got - zeros_before).abs().max()) > 0.1


def _valid_call(**change):
    x, expand, dw, dw_bn, se = _halo_case()
    call = {"x": x, "expand_bn": expand, "dw_weight": dw, "stride": 1, "dw_bn": dw_bn, "se": se}
    call.update(change)
    return call


REFUSALS = {
    "bfloat16": (lambda: _valid_call(x=_valid_call()["x"].bfloat16()), TypeError),
    "not_channels_last": (lambda: _valid_call(x=_valid_call()["x"].contiguous()), ValueError),
    "parameters_elsewhere": (lambda: _valid_call(dw_weight=_valid_call()["dw_weight"].to("meta")), ValueError),
    "autograd_records": (lambda: _valid_call(x=_valid_call()["x"].requires_grad_()), RuntimeError),
    "kernel_size_7": (lambda: _valid_call(dw_weight=torch.zeros(16, 1, 7, 7)), ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_the_kernel_path_refuses(case):
    """The checks a CUDA tensor meets before the kernel (a CPU tensor takes
    the plain version, so they are called directly here)."""
    make, error = REFUSALS[case]
    with pytest.raises(error):
        cuda_mbconv.check(**make())
    cuda_mbconv.check(**_valid_call())  # the unchanged call passes


@contextlib.contextmanager
def _counted(monkeypatch):
    """The calls of both kernel wrappers inside the block (they still run:
    on CPU tensors, their plain versions)."""
    calls = {"mbconv_middle": 0, "bn_act": 0}
    real_mb, real_bn = cuda_mbconv.mbconv_middle, cuda_epilogue.bn_act

    def mb(*args, **kw):
        calls["mbconv_middle"] += 1
        return real_mb(*args, **kw)

    def bn(*args, **kw):
        calls["bn_act"] += 1
        return real_bn(*args, **kw)

    monkeypatch.setattr(cuda_mbconv, "mbconv_middle", mb)
    monkeypatch.setattr(cuda_epilogue, "bn_act", bn)
    yield calls


CHOICE_CASES = {
    # name: (dtype, train mode, trainable parameters by path, autograd context, middle calls, bn_act calls)
    "float32_inference": ("float32", False, None, torch.inference_mode, BLOCKS, INFERENCE_SITES),
    "float32_head_trainable": ("float32", False, lambda p: p[0] == "transfer_head", contextlib.nullcontext,
                               BLOCKS, INFERENCE_SITES),
    "float32_trunk_trainable": ("float32", False, lambda p: True, contextlib.nullcontext, 0, 0),
    "float32_train_mode": ("float32", True, None, torch.no_grad, 0, 0),
    "bfloat16_inference": ("bfloat16", False, None, torch.inference_mode, 0, SITES),
}


@pytest.mark.parametrize("case", sorted(CHOICE_CASES))
def test_the_forward_takes_the_kernel_on_the_float32_inference_path(case, monkeypatch):
    dtype, train, trainable, ctx, middles, sites = CHOICE_CASES[case]
    model = _model(width=0.25, dtype=dtype)
    if trainable is not None:
        set_trainable(model, trainable)
    model.train(train)
    x = _specs()
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(efficientnet, "_on_card", lambda x: True)
    with _counted(monkeypatch) as calls, ctx():
        model(x, drop_generator=gen)
    assert calls == {"mbconv_middle": middles, "bn_act": sites}


def test_the_mocked_inference_path_keeps_the_softmax(monkeypatch):
    model = _model()
    x = _specs(3, seed=4)
    with torch.inference_mode():
        want = model(x)
        monkeypatch.setattr(efficientnet, "_on_card", lambda x: True)
        got = model(x)
    assert float((got - want).abs().max()) < 1e-6


B0_SHAPES = [  # (E, se, k, stride, H, W) of the 16 blocks at 49 x 40 features
    (32, 8, 3, 1, 25, 20), (96, 4, 3, 2, 25, 20), (144, 6, 3, 1, 13, 10), (144, 6, 5, 2, 13, 10),
    (240, 10, 5, 1, 7, 5), (240, 10, 3, 2, 7, 5), (480, 20, 3, 1, 4, 3), (480, 20, 3, 1, 4, 3),
    (480, 20, 5, 1, 4, 3), (672, 28, 5, 1, 4, 3), (672, 28, 5, 1, 4, 3), (672, 28, 5, 2, 4, 3),
    (1152, 48, 5, 1, 2, 2), (1152, 48, 5, 1, 2, 2), (1152, 48, 5, 1, 2, 2), (1152, 48, 3, 1, 2, 2),
]


def test_the_b0_shapes_are_the_model_s(cpu_blocks):
    model, inputs = cpu_blocks
    got = []
    for name, block in _blocks(model):
        x = inputs[name]
        got.append((x.shape[1], block.se_reduce.weight.shape[0], block.dw_conv.kernel_size[0],
                    block.dw_conv.stride[0], x.shape[2], x.shape[3]))
    assert got == B0_SHAPES


@pytest.mark.parametrize("batch, split", [(1, True), (5, True), (64, True), (131, True), (132, False),
                                          (2048, False), (8192, False)])
def test_the_launch_rule_takes_the_split_form_below_a_block_of_threads_an_sm(batch, split):
    for e, se, k, s, h, w in B0_SHAPES:
        top, left, ho, wo = cuda_mbconv.pads(h, w, k, s)
        plan = cuda_mbconv.launch_plan(batch, e, se, k, s, h, w, SMS)
        rows = 1 if plan.split else plan.group
        chunk = cuda_mbconv.THREADS // plan.lanes
        assert plan.split is split
        assert 1 <= plan.group <= min(cuda_mbconv.MAX_GROUP, max(1, batch // SMS))
        assert plan.lanes in (1, 2, 4, 8, 16, 32) and 8 <= chunk <= cuda_mbconv.THREADS
        # a padded plane holds the interior behind its halo and every tap of every item (4 rows a column)
        hp = plan.pp // plan.wp
        assert plan.pp % plan.wp == 0
        if plan.pad:
            assert hp >= top + h and plan.wp >= left + w and plan.pp <= 2 * h * w
            assert hp >= (-(-ho // cuda_mbconv.ROWS) * cuda_mbconv.ROWS - 1) * s + k and plan.wp >= (wo - 1) * s + k
        else:
            assert (hp, plan.wp) == (h, w)
        assert plan.psg % 2 == 1 and plan.psg >= rows * plan.pp and plan.osg % 2 == 1 and plan.osg >= rows * ho * wo
        assert 4 * (chunk * (2 * plan.psg + plan.osg) + -(-plan.group * e // 4) * 4 + plan.group * se) <= \
            cuda_mbconv.SMEM_LIMIT
    # the large planes of the first blocks carry their halo; the late blocks' do not
    assert [cuda_mbconv.launch_plan(batch, e, se, k, s, h, w, SMS).pad for e, se, k, s, h, w in B0_SHAPES] == \
        [True] * 4 + [False, True] + [False] * 10
    # the late blocks, whose SE weights outweigh a sample, take several samples a block of threads
    late = cuda_mbconv.launch_plan(batch, 1152, 48, 5, 1, 2, 2, SMS)
    assert late.group == (1 if split else min(cuda_mbconv.MAX_GROUP, batch // SMS))
    assert cuda_mbconv.launch_plan(batch, 672, 28, 5, 1, 4, 3, SMS).group == 1


def test_the_launch_rule_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_mbconv.launch_plan(8192, 32, 8, 3, 1, 400, 400, SMS)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_pads_are_the_trunk_s_padding(k, stride):
    for h in range(2, 30):
        for w in range(2, 30):
            top, left, ho, wo = cuda_mbconv.pads(h, w, k, stride)
            x = torch.zeros(1, 1, h, w)
            if stride == 2:
                lf, rt, tp, bt = correct_pad((h, w), k)
                assert (top, left) == (tp, lf) and (rt, bt) == (k // 2, k // 2)
                x = F.pad(x, correct_pad((h, w), k))
                ref = F.conv2d(x, torch.zeros(1, 1, k, k), stride=2)
            else:
                assert top == left == k // 2
                ref = F.conv2d(x, torch.zeros(1, 1, k, k), padding=k // 2)
            assert (ho, wo) == tuple(ref.shape[-2:])


# --- on a card


@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return _model("cuda")


def _forms(x, args, sms):
    """The two forms with the same lanes, so that both reduce in one
    order: the split form's plan, and it taken whole (a sample a block of
    threads)."""
    _, e, h, w = x.shape
    split = cuda_mbconv.launch_plan(1, e, args[4].reduce_weight.shape[0], args[1].shape[-1], args[2], h, w, sms)
    return split._replace(split=False), split


@pytest.mark.card
@pytest.mark.parametrize("batch", [5, 64, 8192])
def test_the_kernel_matches_its_twin(card, card_model, batch):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    inputs = _middle_inputs(card_model, _specs(batch, seed=batch, device=card))
    worst = 0.0
    with torch.inference_mode(), exact_float32():  # the twin's cuDNN convolution in float32, not TF32
        for name, block in _blocks(card_model):
            x, args = inputs[name], block.middle_args()
            whole, split = _forms(x, args, sms)
            a, b = cuda_mbconv.launch(x, *args, whole), cuda_mbconv.launch(x, *args, split)
            got = cuda_mbconv.mbconv_middle(x, *args)
            twin = cuda_mbconv.mbconv_middle_plain(x, *args)
            assert torch.equal(a, b), name
            largest = float(twin.abs().max())
            for y in (a, got):
                worst = max(worst, float((y - twin).abs().max()) / largest)
    print(f"batch {batch}: worst |kernel - twin| / largest |twin| {worst:.3g}")
    assert worst <= KERNEL_RTOL


@pytest.mark.card
@pytest.mark.parametrize("stride", [1, 2])
def test_the_halo_on_the_card(card, stride):
    x, expand, dw, dw_bn, se = _halo_case(card)
    got = cuda_mbconv.mbconv_middle(x, expand, dw, stride, dw_bn, se)
    with exact_float32():
        want = cuda_mbconv.mbconv_middle_plain(x, expand, dw, stride, dw_bn, se)
    assert float((got - want).abs().max()) <= KERNEL_RTOL * float(want.abs().max())


@pytest.mark.card
@pytest.mark.parametrize("batch, split_calls", [(64, BLOCKS), (8192, 0)])
def test_a_predict_graph_captures_16_launches(card, card_model, batch, split_calls):
    import copy

    from multilingual_kws_tpu_torch.train import graphs

    model = copy.deepcopy(card_model)  # a program of its own
    x = _specs(batch, seed=1, device=card)
    eager = graphs.eval_forward(model, x)
    predict = graphs.serve(model, graphs.eval_forward)
    counters = (cuda_mbconv.mbconv_middle, cuda_mbconv.mbconv_middle_split, cuda_epilogue.bn_act)
    before = [(w.launches, w.captured) for w in counters]
    for _ in range(2):  # an eager call, then the capture
        predict(x)
    after = [(w.launches, w.captured) for w in counters]
    assert [a[1] - b[1] for a, b in zip(after, before)] == [BLOCKS, split_calls, INFERENCE_SITES]
    # the eager call's launches and the first replay's
    assert [a[0] - b[0] for a, b in zip(after, before)] == [2 * BLOCKS, 2 * split_calls, 2 * INFERENCE_SITES]
    assert torch.equal(predict(x), eager)
    assert cuda_mbconv.mbconv_middle.launches - after[0][0] == BLOCKS  # the replay counts
