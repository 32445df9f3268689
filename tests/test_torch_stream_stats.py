"""The port's ``StreamingAccuracyStats`` against the JAX package's.

The port scores found words with searches in sorted times; the JAX
package's copy keeps the reference's loops (every found word scans the
ground truth, every ground-truth entry scans the found words). On seeded
random cases, which hold duplicate ground-truth times, found words at
exactly and one past ``± time_tolerance_ms``, silence, unknown and other
ground-truth labels, found labels other than the target, a finite horizon
and empty lists, both give the same counters (values and types), the same
``print_accuracy_stats`` string and dict, the same ``delta()`` and the
same exception where the reference raises one.
"""

import numpy as np
import pytest
import torch

from multilingual_kws_tpu.stream import stats as jax_stats
from multilingual_kws_tpu_torch.stream import stats as port_stats


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TARGET = "alpha"
COUNTERS = ["_how_many_gt", "_how_many_gt_matched", "_how_many_fp", "_how_many_c", "_how_many_w",
            "_how_many_fn", "_how_many_gt_target", "_how_many_gt_unknown_or_silence"]
GT_LABELS = ["alpha", "alpha", "_silence_", "_unknown_", "beta"]
# "beta" is accepted unless it correctly matches a "beta" entry, where the
# reference's per-label dict has no key for it and raises
FOUND_LABELS = ["alpha", "alpha", "alpha", "_silence_", "_unknown_", "alpha", "beta"]


def _case(seed: int):
    """(ground truth, two found-word lists, up_to_time_ms, tolerance)."""
    rng = np.random.default_rng(seed)
    tol = [750, 750, 100, 0][seed % 4]
    n_gt = 0 if seed % 8 == 5 else int(rng.integers(1, 30))
    pool = rng.integers(0, 20_000, max(1, n_gt // 2 + 1))  # draws from a pool repeat times
    gt = [(str(rng.choice(GT_LABELS)), int(t)) for t in rng.choice(pool, n_gt)]
    offsets = [0, -tol, tol, -tol - 1, tol + 1, -tol + 1, tol - 1, 3 * tol + 7]

    def found_words(n):
        out = []
        for _ in range(n):
            if gt and rng.random() < 0.7:
                t = gt[int(rng.integers(len(gt)))][1] + int(rng.choice(offsets))
            else:
                t = int(rng.integers(-1_000, 22_000))
            label = str(rng.choice(FOUND_LABELS[:-1] if rng.random() < 0.9 else FOUND_LABELS))
            out.append([label, t] if rng.random() < 0.8 else (label, t, float(rng.random())))
        if rng.random() < 0.5:
            out.sort(key=lambda w: w[1])
        return out

    n_found = 0 if seed % 8 == 3 else int(rng.integers(1, 40))
    up_to = -1 if seed % 3 else int(rng.integers(0, 20_000))
    return gt, found_words(n_found), found_words(int(rng.integers(0, 6))), up_to, tol


def _outcome(module, gt, found_lists, up_to, tol):
    """Each calculation's counters (with their types), printed stats and
    ``delta()``, or the exception it raised."""
    stats = module.StreamingAccuracyStats(TARGET)
    stats.set_ground_truth(gt)
    out = []
    for found in found_lists:
        try:
            stats.calculate_accuracy_stats(found, up_to, tol)
        except Exception as e:  # the reference's exception is part of its behaviour
            out.append(("raised", type(e), e.args))
            return out
        counters = {k: (type(getattr(stats, k)), getattr(stats, k)) for k in COUNTERS}
        counters["_which_matched"] = dict(stats._which_matched)
        counters["_which_wrong"] = dict(stats._which_wrong)
        try:
            delta = stats.delta()
        except ValueError as e:
            delta = ("raised", e.args)
        out.append((counters, stats.print_accuracy_stats(do_print=False), delta))
    return out


@pytest.mark.parametrize("seed", range(24))
def test_stats_match_the_jax_package(seed):
    gt, found, more, up_to, tol = _case(seed)
    want = _outcome(jax_stats, gt, [found, more], up_to, tol)
    got = _outcome(port_stats, gt, [found, more], up_to, tol)
    assert got == want


@pytest.mark.parametrize("gt, found", [
    ([], []),
    ([("alpha", 1000)], []),
    ([], [["alpha", 1000]]),
    ([("alpha", 1000), ("_unknown_", 1000), ("alpha", 1000)], [["alpha", 1000], ["alpha", 1500], ["alpha", 250]]),
    ([("_silence_", 2000), ("_unknown_", 2000)], [["_silence_", 2750], ["_unknown_", 1250], ["alpha", 2000]]),
    ([("alpha", 1000), ("beta", 3000)], [["beta", 1000], ["beta", 4000]]),
    ([("alpha", 1000), ("beta", 3000)], [["alpha", 1000], ["beta", 3100], ["alpha", 3200]]),
    ([("alpha", 2250), ("alpha", 3000)], [["alpha", 2250], ["alpha", 2300]]),  # at 1500's horizon, 1500 + 750
    ([("alpha", 2250), ("_silence_", 2249)], []),
])
@pytest.mark.parametrize("up_to", [-1, 1500])
def test_stats_edge_cases_match_the_jax_package(gt, found, up_to):
    """Empty lists, one time held by several labels, words exactly at the
    tolerance, entries exactly at the horizon, and a non-target label
    accepted (no correct match) or refused (a correct match: KeyError) as
    the reference does."""
    want = _outcome(jax_stats, gt, [found], up_to, 750)
    assert _outcome(port_stats, gt, [found], up_to, 750) == want
