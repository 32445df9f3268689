"""A run whose timed path is broken underneath comes out not correct: each
fault a cell can have, planted in the program on the CPU at a tiny size
(the harness's look for a card is skipped: ``run_cell`` on the CPU).

The faults: a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest; an answer altered where it is produced
(a softmax row, a detection, a window's or a training batch's features);
for pretraining also faults that show only after the first step (Adam
without its first moment, Adam's step count left at 1, an epoch that
replays the first step's rows). One card, so no exchange between cards to
leave out."""

import pytest
import torch

from kwsbench import run
from kwsbench.tests.conftest import SECONDS, TINY


def run_tiny(cell, seed=3):
    return run.run_cell(cell, seed, SECONDS[cell], False, device="cpu", overrides=TINY[cell])


def altered_rows(monkeypatch):
    import multilingual_kws_tpu_torch.stream.engine as engine

    serve = engine.model_predict_fn

    def predict_fn(model):
        inner = serve(model)

        def altered(x):
            p = inner(x).clone()
            p[0] = p[0].flip(0)  # one window's row, as the predict produces it
            return p

        return altered

    monkeypatch.setattr(engine, "model_predict_fn", predict_fn)


def dropped_scan_detection(monkeypatch):
    import multilingual_kws_tpu_torch.stream.engine as engine

    detect = engine.detect_all_thresholds

    def dropping(*args, **kw):
        found = detect(*args, **kw)
        for words, conf in found.values():
            if words:
                del words[0], conf[0]
        return found

    monkeypatch.setattr(engine, "detect_all_thresholds", dropping)


def altered_stream_features(monkeypatch):
    import multilingual_kws_tpu_torch.stream.engine as engine

    chunks = engine.stream_feature_chunks

    def altering(*args, **kw):
        for c in chunks(*args, **kw):
            c = c.clone()
            c[0, 10] += 1.0  # one window's frame, as the frontend produces it
            yield c

    monkeypatch.setattr(engine, "stream_feature_chunks", altering)


def no_first_moment(monkeypatch):
    """Adam with b1 = 0: the first step is the same, the second is not."""
    import multilingual_kws_tpu_torch.train.pretrain as pretrain

    monkeypatch.setattr(pretrain, "flat_adam", lambda params, lr: torch.optim.Adam(
        list(params), lr=lr, betas=(0.0, 0.999), eps=1e-7, foreach=True))


def stale_step(monkeypatch):
    """Adam whose step count stays at 1: the first step's bias correction
    at every step."""
    import multilingual_kws_tpu_torch.train.pretrain as pretrain

    class Stale(torch.optim.Adam):
        def step(self, closure=None):
            for state in self.state.values():
                state["step"].zero_()
            return super().step(closure)

    monkeypatch.setattr(pretrain, "flat_adam", lambda params, lr: Stale(
        list(params), lr=lr, betas=(0.9, 0.999), eps=1e-7, foreach=True))


def repeated_rows(monkeypatch):
    """An epoch whose every step reads the first step's rows, labels and
    silence flags."""
    from multilingual_kws_tpu_torch.train import graphs

    def one_step(self):
        c = self._counter
        idx, lbl, sil = (t[0] for t in self._inputs)
        loss, acc = graphs._inside(self.step, idx, lbl, sil)
        self._losses.index_copy_(0, c, loss.reshape(1).to(torch.float32))
        self._accs.index_copy_(0, c, acc.reshape(1).to(torch.float32))
        c.add_(1)

    monkeypatch.setattr(graphs.EpochGraph, "_one_step", one_step)


def unchanged_state(monkeypatch):
    import multilingual_kws_tpu_torch.train.pretrain as pretrain
    from multilingual_kws_tpu_torch.train import steps

    monkeypatch.setattr(pretrain, "flat_adam", lambda params, lr: steps.flat_adam(params, 0.0))


def half_batch(monkeypatch):
    from multilingual_kws_tpu_torch.train import steps

    ce = steps.sparse_ce_from_logits
    monkeypatch.setattr(steps, "sparse_ce_from_logits", lambda logits, labels: ce(logits, labels)[: labels.shape[0] // 2])


def altered_features(monkeypatch):
    from multilingual_kws_tpu_torch.data import dataset

    featurize = dataset.augment_featurize

    def altering(*args, **kw):
        specs = featurize(*args, **kw).clone()
        specs[0, 10:20] += 1.0  # one clip's frames, as the transform produces them
        return specs

    monkeypatch.setattr(dataset, "augment_featurize", altering)


def unchanged_head(monkeypatch):
    from multilingual_kws_tpu_torch.train import steps

    adam = steps.adam
    monkeypatch.setattr(steps, "adam", lambda params, lr: adam(params, 0.0))


def half_batch_of_probs(monkeypatch):
    from multilingual_kws_tpu_torch.train import steps

    ce = steps.sparse_ce_from_probs
    monkeypatch.setattr(steps, "sparse_ce_from_probs", lambda probs, labels: ce(probs, labels)[: labels.shape[0] // 2])


FAULTS = [
    ("scan-b0t3-10min", altered_rows, "softmax_gap"),
    ("scan-b0t3-10min", dropped_scan_detection, "detections_mismatch"),
    ("scan-b0t3-10min", altered_stream_features, "frontend_mismatch"),
    ("pretrain-b0e761-b64", unchanged_state, "update_gap"),
    ("pretrain-b0e761-b64", half_batch, "loss_gap"),
    ("pretrain-b0e761-b64", altered_features, "spec_mismatch_share"),
    ("pretrain-b0e761-b64", no_first_moment, "replay_loss_gap"),
    ("pretrain-b0e761-b64", stale_step, "replay_loss_gap"),
    ("pretrain-b0e761-b64", repeated_rows, "replay_loss_gap"),
    ("finetune-b0t3-5shot", unchanged_head, "update_gap"),
    ("finetune-b0t3-5shot", half_batch_of_probs, "loss_gap"),
    ("finetune-b0t3-5shot", altered_features, "spec_mismatch_share"),
]


@pytest.mark.parametrize("cell,fault,number", FAULTS, ids=[f"{c}-{f.__name__}" for c, f, _ in FAULTS])
def test_a_fault_makes_the_run_not_correct(monkeypatch, cell, fault, number):
    fault(monkeypatch)
    res = run_tiny(cell)
    assert res["correct"] is False
    c = res["checks"][number]
    assert not (isinstance(c["value"], float) and c["value"] < c["limit"]), res["checks"]


def test_an_unchanged_state_reads_one():
    """The training measure of a parameter change that did not happen."""
    from kwsbench.training import leaf_gaps

    ref = {"a": torch.ones(3), "b": torch.full((2,), 2.0)}
    assert max(leaf_gaps({k: torch.zeros_like(v) for k, v in ref.items()}, ref, list(ref)).values()) == 1.0
