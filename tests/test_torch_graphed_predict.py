"""The port's inference programs (``train/graphs.ProgramGraphs``: the
counterpart of the JAX package's jitted predicts) on the CPU.

On the CPU a program has no graph: every call is its function, and the keys
(input shapes, dtypes and devices; the modules' training flags and weight
addresses) and their least-recently-used order are kept as on a card. So
these tests hold the programs' outputs to the eager calls with ``==``, and
to the JAX package's ``_cached_predict`` within tests/test_torch_model.py's
tolerance (softmax atol 1e-5: the same float32 weights and inputs, sums in
another order in oneDNN than in XLA:CPU). The stream and realtime paths
through a model's program give the same rows and detections as the same
paths through an eager predict, ``==``. The graphs themselves run only on a
card: ``chip_smoke.py``'s phase m holds graphed to eager there.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from helpers import tiny_transfer_model
from multilingual_kws_tpu.train.finetune import _cached_predict
from multilingual_kws_tpu_torch import bench
from multilingual_kws_tpu_torch.analysis.distance_filtering import make_embedding_fn
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict
from multilingual_kws_tpu_torch.models.kws_model import KWSTransferModel
from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
from multilingual_kws_tpu_torch.stream import engine
from multilingual_kws_tpu_torch.stream.realtime import RealtimeDetector
from multilingual_kws_tpu_torch.utils.wav import write_wav
from multilingual_kws_tpu_torch.train import graphs
from multilingual_kws_tpu_torch.train.finetune import FinetuneResult
from test_torch_bench import TINY_TRUNK
from test_torch_model import ATOL, _flax_variables, _inputs, _tiny_trunk
from test_torch_realtime import THRESHOLD, models, stream_audio  # noqa: F401 (fixtures)


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
def flax_weights():
    fm = tiny_transfer_model(input_scale=1.0)
    return fm, _flax_variables(fm, _inputs(), seed=5)


def _port(variables) -> KWSTransferModel:
    model = KWSTransferModel(_tiny_trunk(), 3).eval()
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def _program(model) -> graphs.ProgramGraphs:
    return graphs.module_program(model, graphs.eval_forward)


def _eager(model, x):
    with torch.no_grad():
        return model(x)


@pytest.mark.parametrize("batch", [1, 5, 16])
def test_program_equals_eager_and_the_jax_predict(flax_weights, batch):
    fm, v = flax_weights
    model = _port(v)
    predict = engine.model_predict_fn(model)
    program = _program(model)
    x = _inputs(batch, seed=batch)
    want = jax.tree_util.tree_map(np.asarray, _cached_predict(fm)(v, x))
    # the key's eager call, then the calls a card captures and replays
    outs = [predict(torch.from_numpy(x)) for _ in range(3)]
    eager = _eager(model, torch.from_numpy(x))
    assert all(torch.equal(o, eager) for o in outs) and outs[0].shape == (batch, 3)
    np.testing.assert_allclose(outs[-1].numpy(), want, rtol=0, atol=ATOL)
    assert len(program.keys()) == 1 and program.eager_calls == 3 and program.captures == 0


def test_key_follows_shapes_and_weight_storage(flax_weights):
    model = _port(flax_weights[1])
    program = _program(model)
    x5, x7 = (torch.from_numpy(_inputs(n, seed=n)) for n in (5, 7))
    program(x5)
    program(x5)
    (k5,) = program.keys()
    assert program.key(x5) == k5
    program(x7)
    assert program.keys()[0] == k5 and len(program.keys()) == 2

    # an in-place update keeps the key, and the call reads the new weights
    before = program(x5)
    with torch.no_grad():
        model.transfer_head.out.bias.add_(torch.tensor([0.0, 0.0, 2.0]))
    assert program.key(x5) == k5
    after = program(x5)
    assert torch.equal(after, _eager(model, x5)) and not torch.equal(after, before)
    assert program.keys()[-1] == k5 and len(program.keys()) == 2

    # new storage gives a new key, and the old weights' keys go
    sd = {k: t.clone() for k, t in model.state_dict().items()}
    model.load_state_dict(sd, assign=True)
    k5_new = program.key(x5)
    assert k5_new != k5 and k5_new[0] == k5[0]
    assert torch.equal(program(x5), after)
    assert program.keys() == [k5_new]
    model.transfer_head.out.weight = torch.nn.Parameter(model.transfer_head.out.weight.detach().clone())
    now = program.key(x5)
    assert now != k5_new

    # so do another dtype and the training flag
    assert program.key(x5.double()) != now
    model.train()
    assert program.key(x5) != now
    engine.model_predict_fn(model)  # serving puts the model back in eval mode
    assert _program(model) is program and not model.training


def test_lru_keeps_at_most_eight_keys(flax_weights):
    model = _port(flax_weights[1])
    program = _program(model)
    assert program.max_shapes == graphs.MAX_SHAPES == 8
    batches = list(range(1, 11))
    for b in batches:
        program(torch.zeros(b, 49, 40, 1))
    assert [k[0][0][0][0] for k in program.keys()] == batches[-8:]
    program(torch.zeros(3, 49, 40, 1))  # a kept key becomes the most recent
    program(torch.zeros(1, 49, 40, 1))  # a dropped one comes back, dropping the least recent
    assert [k[0][0][0][0] for k in program.keys()] == [5, 6, 7, 8, 9, 10, 3, 1]


def test_programs_are_cached_per_model_and_method(flax_weights):
    model = _port(flax_weights[1])
    result = FinetuneResult("n", model, {}, None)
    first, second = result.predict_fn(), result.predict_fn()
    x = _inputs(4, seed=1)
    assert torch.equal(first(x), _eager(model, torch.from_numpy(x)))  # a host array goes in
    assert torch.equal(second(x.astype(np.float64)), first(x))
    program = _program(model)
    assert len(program.keys()) == 1 and program.eager_calls == 3
    embed = make_embedding_fn(model)
    with torch.no_grad():
        np.testing.assert_array_equal(embed(x), model.embed(torch.from_numpy(x)).numpy())
    assert graphs.module_program(model, graphs.eval_embed) is not program
    # a copy of the model starts with no program; its programs serve it
    clone = copy.deepcopy(model)
    assert not clone.__dict__["_inference_programs"]
    assert _program(clone) is not program


def test_served_predict_keeps_its_model_alive_and_the_program_does_not(flax_weights):
    x = torch.from_numpy(_inputs(2))
    predict = engine.model_predict_fn(_port(flax_weights[1]))  # the predict holds the only reference
    assert predict(x).shape == (2, 3)
    program = _program(_port(flax_weights[1]))  # its model is gone once this line ends
    with pytest.raises(RuntimeError, match="freed"):
        program(x)
    model = _port(flax_weights[1])
    assert graphs.ProgramGraphs(model, [model]).device(x) == torch.device("cpu")
    assert graphs.ProgramGraphs(torch.neg).device(x) == torch.device("cpu")


def test_stream_through_the_program_equals_eager(tmp_path, stream_audio, models):  # noqa: F811
    """One program serves every batch of the stream (the zero-padded tail
    included): one key, as the JAX engine's one slicer for every offset."""
    port = copy.deepcopy(models[1])  # a model of this test's own: its program's keys are this test's
    wav, labels = tmp_path / "s.wav", tmp_path / "l.txt"
    write_wav(wav, stream_audio, 16000)
    labels.write_text("")
    flags = [engine.StreamFlags(wav=str(wav), ground_truth=str(labels), target_keyword="alpha",
                                detection_thresholds=[0.3, THRESHOLD, 0.7])]
    program = _program(port)
    runs = {}
    for name, predict in (("graphed", engine.model_predict_fn(port)), ("eager", lambda s: _eager(port, s))):
        runs[name] = engine.calculate_streaming_accuracy(predict, flags, batch_size=64, verbose=False, device="cpu")
    (res_g, inf_g), (res_e, inf_e) = runs["graphed"], runs["eager"]
    assert inf_g.shape[0] > 2 * 64 and np.array_equal(inf_g, inf_e)
    found = {th: r[0] for th, r in res_g[0][1].items()}
    assert found == {th: r[0] for th, r in res_e[0][1].items()} and any(found.values())
    assert len(program.keys()) == 1 and program.eager_calls == -(-inf_g.shape[0] // 64)


@pytest.mark.parametrize("chunk_ms", [20, 100, 500])
def test_realtime_feeds_through_the_program(stream_audio, models, chunk_ms):  # noqa: F811
    """Feeds of 1, 5 and 25 windows, and the shorter last feed, give the
    eager predict's detections; each feed's batch is a key."""
    port = copy.deepcopy(models[1])
    chunk = 16 * chunk_ms
    audio = stream_audio[: len(stream_audio) - chunk // 2]  # the last feed is shorter
    runs = {}
    program = _program(port)
    for name, predict in (("graphed", port), ("eager", lambda s: _eager(port, s))):
        det = RealtimeDetector("alpha", predict, detection_threshold=THRESHOLD, device="cpu")
        found = []
        for i in range(0, len(audio), chunk):
            found.extend((d.time_ms, d.confidence) for d in det.feed(audio[i : i + chunk]))
        runs[name] = found
    assert runs["graphed"] and runs["graphed"] == runs["eager"]
    assert program.eager_calls > 0
    batches = {k[0][0][0][0] for k in program.keys()}
    assert chunk_ms // 20 in batches and len(batches) <= 3


def test_bench_headline_step_is_one_program():
    fe = MicroFrontendTorch(device="cpu")
    model = bench.embedding_model("float32", "cpu", num_labels=5, **TINY_TRUNK)
    step = bench.headline_step(fe, model)
    audio = torch.from_numpy(np.random.default_rng(0).normal(0, 0.1, (2, 16000)).astype(np.float32))
    eps = torch.zeros(())
    outs = [eps]
    for _ in range(3):
        outs.append(step(audio, outs[-1]))
    with torch.inference_mode():
        want = torch.tanh(model(fe.features(audio + outs[2])[..., None]).float().mean()) * 1e-30
    assert outs[-1].shape == () and torch.equal(outs[-1], want)
    assert len(step.keys()) == 1 and step.eager_calls == 3
