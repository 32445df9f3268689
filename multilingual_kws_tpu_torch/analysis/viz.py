"""Analysis visualization: ROC bands, FRR/FAR curves, confusion matrices,
streaming detection video frames.

Data-side equivalents of the reference's plotting modules — stream_viz.py
(FRR/FAR curves), band_viz.py (banded ROC across a language's keywords),
embedding_confusion_matrix.py, streaming_video.py (per-frame detection
rendering). Each function returns plain arrays/dicts; the *_plot helpers
are thin matplotlib wrappers gated behind lazy imports so the core never
depends on a plotting stack.

The port's own copy of ``multilingual_kws_tpu/analysis/viz.py`` (numpy only): the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def frr_far_curves(
    target_confidences: np.ndarray,
    nontarget_confidences: np.ndarray,
    thresholds: Optional[np.ndarray] = None,
) -> Dict:
    """False-rejection / false-acceptance rates vs threshold (the
    stream_viz.py:76 FRR/FAR view). FRR = P(target < t), FAR = P(nontarget > t)."""
    target = np.asarray(target_confidences)
    nontarget = np.asarray(nontarget_confidences)
    thresholds = (
        np.arange(0.0, 1.01, 0.01) if thresholds is None else np.asarray(thresholds)
    )
    frr = [(target < t).mean() if target.size else 0.0 for t in thresholds]
    far = [(nontarget > t).mean() if nontarget.size else 0.0 for t in thresholds]
    return dict(thresholds=thresholds, frr=np.asarray(frr), far=np.asarray(far))


def roc_band(per_word_curves: Sequence[Tuple[np.ndarray, np.ndarray]]) -> Dict:
    """Banded ROC over many keywords (band_viz.py:33-147): per FPR grid point,
    the mean / min / max TPR across words.

    per_word_curves: [(tprs, fprs)] — e.g. from analysis.roc.roc_sc per word.
    """
    grid = np.linspace(0, 1, 101)
    interps = []
    for tprs, fprs in per_word_curves:
        f = np.asarray(fprs)
        t = np.asarray(tprs)
        order = np.argsort(f)
        interps.append(np.interp(grid, f[order], t[order]))
    stack = np.stack(interps)
    return dict(
        fpr_grid=grid,
        tpr_mean=stack.mean(axis=0),
        tpr_min=stack.min(axis=0),
        tpr_max=stack.max(axis=0),
        num_words=len(interps),
    )


def confusion_matrix(
    true_labels: np.ndarray, pred_labels: np.ndarray, num_labels: int
) -> np.ndarray:
    """(num_labels, num_labels) count matrix, rows = true
    (embedding_confusion_matrix.py semantics)."""
    cm = np.zeros((num_labels, num_labels), dtype=np.int64)
    np.add.at(cm, (np.asarray(true_labels), np.asarray(pred_labels)), 1)
    return cm


def top_confusions(
    cm: np.ndarray, label_names: Sequence[str], k: int = 20
) -> List[Tuple[str, str, int]]:
    """The k largest off-diagonal confusion pairs [(true, predicted, count)]."""
    off = cm.copy()
    np.fill_diagonal(off, 0)
    flat = np.argsort(off, axis=None)[::-1][:k]
    out = []
    for ix in flat:
        i, j = divmod(int(ix), cm.shape[1])
        if off[i, j] == 0:
            break
        out.append((label_names[i], label_names[j], int(off[i, j])))
    return out


def detection_video_frames(
    inferences: np.ndarray,
    times_ms: np.ndarray,
    found_words: Sequence[Sequence],
    target_name: str,
    window_s: float = 5.0,
    fps: float = 10.0,
) -> List[Dict]:
    """Per-video-frame render data (streaming_video.py:19-236): for each
    output frame, the confidence trace inside a sliding window plus any
    detection markers. Rendering to pixels is the caller's concern."""
    inferences = np.asarray(inferences)
    times = np.asarray(times_ms, dtype=np.float64)
    if times.size == 0:
        return []
    total_ms = float(times[-1])
    frames = []
    n_frames = int(total_ms / 1000.0 * fps) + 1
    dets = [(w, t) for w, t in ((f[0], f[1]) for f in found_words)]
    for k in range(n_frames):
        now = k / fps * 1000.0
        lo = now - window_s * 1000.0
        mask = (times >= lo) & (times <= now)
        frames.append(
            dict(
                now_ms=now,
                trace_times=times[mask],
                trace_conf=inferences[mask, -1] if inferences.ndim == 2 else inferences[mask],
                detections=[(w, t) for w, t in dets if lo <= t <= now],
                target=target_name,
            )
        )
    return frames


# -- matplotlib wrappers (lazy; optional) --------------------------------------


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_frr_far(curves: Dict, dest=None, title: str = ""):
    plt = _plt()
    fig, ax = plt.subplots()
    ax.plot(curves["thresholds"], curves["frr"], label="FRR")
    ax.plot(curves["thresholds"], curves["far"], label="FAR")
    ax.set_xlabel("threshold")
    ax.set_ylabel("rate")
    ax.set_title(title)
    ax.legend()
    if dest:
        fig.savefig(dest, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_roc_band(band: Dict, dest=None, title: str = ""):
    plt = _plt()
    fig, ax = plt.subplots()
    ax.plot(band["fpr_grid"], band["tpr_mean"], label=f"mean ({band['num_words']} words)")
    ax.fill_between(band["fpr_grid"], band["tpr_min"], band["tpr_max"], alpha=0.25)
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_title(title)
    ax.legend(loc="lower right")
    if dest:
        fig.savefig(dest, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_streaming_roc(rocs: Sequence[Dict], dest=None, fa_cutoff: float = 50.0,
                       xmax: float = 200.0):
    """TPR vs FA/h with the nominal cutoff line (luganda_eval.py:165-188)."""
    plt = _plt()
    fig, ax = plt.subplots()
    for roc in rocs:
        ax.plot(roc["fa_per_hour"], roc["tprs"], label=roc.get("keyword", ""))
    ax.axvline(x=fa_cutoff, linestyle="--", color="black",
               label="nominal cutoff for false accepts")
    ax.set_xlim(0, xmax)
    ax.set_ylim(0, 1)
    ax.set_xlabel("False Accepts per Hour")
    ax.set_ylabel("True Positive Rate")
    ax.legend(loc="lower right")
    if dest:
        fig.savefig(dest, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_confusion(cm: np.ndarray, dest=None, title: str = ""):
    plt = _plt()
    fig, ax = plt.subplots()
    row_sums = np.maximum(cm.sum(axis=1, keepdims=True), 1)
    ax.imshow(cm / row_sums, cmap="viridis")
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    ax.set_title(title)
    if dest:
        fig.savefig(dest, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
