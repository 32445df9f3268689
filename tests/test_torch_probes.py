"""The port's rate probes (``probes/rates.py``) and frontend cost probe
(``probes/fft_cost.py``). On the CPU the rate kernels' plain versions run:
each is held ``==`` to numpy arithmetic (int32 wraps; the product chain is
exact because w is a permutation matrix and x holds small integers). The
probes themselves measure a card: without one they raise.
"""

import numpy as np
import pytest
import torch

from multilingual_kws_tpu_torch.probes import fft_cost, rates


@pytest.fixture(scope="module")
def inputs():
    return rates.probe_inputs("cpu", seed=1, rows=16)


def _numpy_chain(op, x, y, k):
    v = x.copy()
    with np.errstate(over="ignore"):
        for _ in range(0 if op == "copy" else k):
            if op == "alu":
                v = (v + y) ^ y
            elif op == "mul":
                v = v * y
            elif op == "cmpsel":
                v = np.where((v & 1) == 0, y, v)
            else:
                v = np.roll(v.reshape(-1, 32), -1, axis=1).reshape(v.shape)
    return v


@pytest.mark.parametrize("op", list(rates.OPS))
def test_rate_chain_matches_numpy_int32(inputs, op):
    x, y, _, _ = inputs
    got = rates.rate_chain(x, y, op, 9)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _numpy_chain(op, x.numpy(), y.numpy(), 9))


def test_mul_chain_wraps():
    """Large factors: the product wraps mod 2^32 as int32 arithmetic does."""
    x = torch.full((4, 256), 2**31 - 1, dtype=torch.int32)
    y = torch.full((4, 256), -(2**30) + 7, dtype=torch.int32)
    np.testing.assert_array_equal(rates.rate_chain(x, y, "mul", 3).numpy(), _numpy_chain("mul", x.numpy(), y.numpy(), 3))


def test_dot_chain_with_a_permutation_matches_numpy(inputs):
    _, _, xd, w = inputs
    assert torch.equal(w.sum(0), torch.ones(256)) and torch.equal(w.sum(1), torch.ones(256))
    got = rates.dot_chain(xd, w, 4)
    want = xd.numpy()
    for _ in range(4):
        want = want @ w.numpy()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(rates.dot_chain(xd, w, 0).numpy(), xd.numpy())


def test_wrappers_check_their_inputs(inputs):
    x, y, xd, w = inputs
    with pytest.raises(ValueError):
        rates.rate_chain(x, y, "div", 1)
    with pytest.raises(ValueError):
        rates.rate_chain(x[:, :100], y[:, :100], "alu", 1)
    with pytest.raises(ValueError):
        rates.dot_chain(xd[:, :128], w, 1)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("probe", [rates.measure_rates, fft_cost.fft_cost], ids=["measure_rates", "fft_cost"])
def test_probes_raise_without_a_card(no_card, probe):
    with pytest.raises(RuntimeError, match="device"):
        probe()
    with pytest.raises(ValueError, match="CUDA"):
        probe(device="cpu")
