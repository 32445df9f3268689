"""The port's rate probes (``probes/rates.py``), frontend cost probe
(``probes/fft_cost.py``) and instruction census (``probes/sass.py``). On
the CPU the rate kernels' plain versions run: each is held ``==`` to numpy
arithmetic (int32 wraps; the product chain is exact because w is a
permutation matrix and x holds small integers), and the dot chain's plain
version to the reference probe's own step on JAX's CPU. The probes
themselves measure a card: without one they raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_kws_tpu_torch.probes import fft_cost, rates, sass


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


@pytest.mark.parametrize("k", [0, 1, 5])
@pytest.mark.parametrize("rows", [16, 64, 192])
def test_dot_chain_with_a_permutation_matches_numpy(rows, k):
    _, _, xd, w = rates.probe_inputs("cpu", seed=1, rows=rows)
    assert torch.equal(w.sum(0), torch.ones(256)) and torch.equal(w.sum(1), torch.ones(256))
    got = rates.dot_chain(xd, w, k)
    want = xd.numpy()
    for _ in range(k):
        want = want @ w.numpy()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 3])
def test_dot_chain_plain_matches_the_reference_step(k):
    """The plain version against the JAX probe's step body
    (``tools_dev/vpu_roofline.py::_dot_rate_kernel``) without its
    ``pallas_call``: ``jnp.dot(bf16(x), w, preferred_element_type=f32)``,
    k times, on inputs that round in bf16 (w entries in {0, 0.5}, x
    not integer), where the two agree within float32 summation order."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 4, (64, 256)).astype(np.float32)
    w = (rng.random((256, 256)) < 4 / 256).astype(np.float32) * 0.5
    acc = jnp.asarray(x)
    for _ in range(k):
        acc = jnp.dot(acc.astype(jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), preferred_element_type=jnp.float32)
    got = rates.dot_chain_plain(torch.from_numpy(x), torch.from_numpy(w), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(acc), rtol=2 ** -7, atol=1e-6)


def test_swizzled_w_is_the_128_byte_swizzle():
    """Read back through the 128-byte swizzle as the hardware applies it to
    shared-memory addresses (bits 4-6 of a byte address xor bits 7-9), the
    image is w^T in four slabs of 64 columns, rows of 128 bytes."""
    w = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (256, 256)).astype(np.float32))
    img = rates.swizzled_w(w).view(torch.int16).numpy()
    wt = w.to(torch.bfloat16).t().contiguous().view(torch.int16).numpy()
    addr = np.arange(img.size) * 2
    plain = addr ^ (((addr >> 7) & 7) << 4)
    slab, rest = plain // (256 * 128), plain % (256 * 128)
    n, col = rest // 128, slab * 64 + (rest % 128) // 2
    np.testing.assert_array_equal(img, wt[n, col])


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


SASS = """
        Function : _ZN12_GLOBAL__N_16kernelEPi
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   IMAD.WIDE.U32 R2, R3, R4, RZ ;
        /*0020*/                   SHF.R.U64 R2, R2, 0xe, R3 ;
        /*0030*/              @!P0 BRA 0x60 ;
        /*0040*/                   FLO.U32 R5, R2 ;
        /*0050*/                   BRA 0x70 ;
        /*0060*/                   IADD3 R5, R5, 0x1, RZ ;
        /*0070*/                   LDS.64 R8, [R5] ;
        /*0080*/               @P2 STG.E desc[UR4][R10.64], R12 ;
        /*0090*/              @!P2 STG.E desc[UR4][R10.64], R13 ;
        /*00a0*/                   STG.E.128 desc[UR4][R14.64], R16 ;
        /*00b0*/              @P1 BRA 0x10 ;
        /*00c0*/                   EXIT ;
"""


def test_sass_census_counts_the_fall_through_path():
    (loop,) = sass.census_text(SASS, "kernel")
    assert loop["instructions"] == 11  # 0x10 .. 0xb0
    # the path skips 0x60 (the unconditional branch jumps over it)
    assert loop["path_instructions"] == 10
    assert loop["elements"] == 1 + 4  # complementary stores count once
    by = loop["by_class"]
    assert by["int64_parts"] == 2 and by["quarter_rate"] == 1 and by["global_store"] == 3
    assert by["branch"] == 3 and by["shared"] == 1 and by["int32"] == 0
    assert loop["by_pipe"] == {"fma": 1, "alu": 1, "other": 7, "quarter": 1}
    t = sass.issue_bound_ms(loop, 5e9, 1e12)
    assert t["bound"] == max(t["dispatch"], t["alu"], t["quarter"]) == t["dispatch"]
