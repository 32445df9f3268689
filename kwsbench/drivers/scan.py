"""The stream scan: ``stream/engine.calculate_streaming_accuracy`` over one
long synthesized stream, closed loop, call after call.

Set-up writes the seeded stream and its ground truth under the run's
scratch directory, draws the few-shot model's weights (``weights``), builds
the program's model and warms the engine with two calls (the frontend's
program of the chunk's window count and the predict program of the batch
shape each run eagerly once, then capture). The window calls the engine
until ``--seconds`` have passed; each call reads the wav, runs the exact
frontend (B2, B3), the model over every window in batches of
``batch_size``, pulls the softmax rows and runs the detector at every
threshold.

The check, after the window: the features the engine's frontend made in
the window's last call (kept as the engine's chunk iterator yields them)
against the reference frontend (==); every call's softmax rows against the
reference model's on the reference features (widest gap); every call's
detections against the reference detector run on that call's rows (==).
"""

from __future__ import annotations

import contextlib
import hashlib
import time
from typing import Dict

import numpy as np
import torch

from kwsbench.checks import verdict
from kwsbench.counts import frontend as fcounts
from kwsbench.counts import model as mcounts
from kwsbench.reference import detector as ref_detector
from kwsbench.reference import frontend as ref_frontend
from kwsbench.reference.model import Model, exact, tf32
from kwsbench.traffic import audio
from kwsbench.weights import clips_of, dims, program_model, transfer_state

KEYWORD = "alpha"


def flags_of(cell, wav: str, gt: str):
    from multilingual_kws_tpu_torch.stream.engine import StreamFlags

    t = cell.traffic
    return StreamFlags(wav=wav, ground_truth=gt, target_keyword=KEYWORD,
                       detection_thresholds=[round(float(x), 2) for x in t["thresholds"]])


def stream_files(cell):
    """The seeded stream (int16) and its wav and ground-truth files."""
    samples, labels = audio.stream(int(cell.traffic["stream_s"]), cell.seed, KEYWORD)
    wav, gt = cell.workdir / "stream.wav", cell.workdir / "stream_labels.txt"
    audio.write_wav(wav, samples)
    gt.write_text("".join(f"{k}, {ms}\n" for k, ms in labels))
    return samples, str(wav), str(gt)


def build_model(cell, samples: np.ndarray, compute_dtype: str = None):
    """(weights, the program's model) of the cell's configuration."""
    calib = clips_of(samples, int(cell.config["calibration_clips"]), cell.seed)
    state = transfer_state(cell.config, cell.seed, cell.device, calib, float(cell.traffic["target_median"]))
    return state, program_model(cell.config, state, cell.device, compute_dtype)


def setup(cell) -> Dict:
    from multilingual_kws_tpu_torch.stream.engine import calculate_streaming_accuracy

    samples, wav, gt = stream_files(cell)
    state, model = build_model(cell, samples)
    flags = flags_of(cell, wav, gt)
    batch = int(cell.traffic["batch_size"])
    for _ in range(2):
        calculate_streaming_accuracy(model, [flags], batch_size=batch, verbose=False, device=cell.device)
    if cell.device != "cpu":
        torch.cuda.synchronize()
    return {"samples": samples, "state": state, "model": model, "flags": flags, "batch": batch}


@contextlib.contextmanager
def kept_features(chunks: list):
    """The engine's frontend chunks, as its iterator yields them to the
    engine, appended to ``chunks`` inside the block (references to the
    program's own tensors, not copies)."""
    import multilingual_kws_tpu_torch.stream.engine as engine

    original = engine.stream_feature_chunks

    def keeping(*args, **kw):
        for chunk in original(*args, **kw):
            chunks.append(chunk)
            yield chunk

    engine.stream_feature_chunks = keeping
    try:
        yield chunks
    finally:
        engine.stream_feature_chunks = original


def window(cell, st) -> Dict:
    from multilingual_kws_tpu_torch.stream.engine import calculate_streaming_accuracy

    audio_s = st["samples"].shape[0] / audio.SR
    outputs, walls, chunks = [], [], []
    cell.tracer.start()
    t_end = time.perf_counter() + cell.seconds
    with kept_features(chunks):
        while True:
            chunks.clear()  # the last call's are kept
            t0 = time.perf_counter()
            with cell.spans.span("calculate_streaming_accuracy"):
                results, rows = calculate_streaming_accuracy(st["model"], [st["flags"]], batch_size=st["batch"],
                                                             verbose=False, device=cell.device)
            t1 = time.perf_counter()
            walls.append(t1 - t0)
            outputs.append((results[0][1], rows))
            found = results[0][1]
            if t1 >= t_end:
                break
    cell.tracer.stop()
    n_w = outputs[0][1].shape[0]
    cell.counts.update(streams=len(walls), windows=n_w * len(walls),
                       frontend_least_s=len(walls) * (fcounts.stream_prefix_s(st["samples"].shape[0])
                                                      + fcounts.stream_suffix_s(st["samples"].shape[0], n_w)),
                       forward_flops=mcounts.forward_flops(cell.config["top"], 3, *dims(cell.config)))
    st["outputs"], st["features"] = outputs, list(chunks)
    return {"attempted": len(walls), "failed": 0,
            "metrics": {"scan_audio_s_per_s": audio_s * len(walls) / sum(walls)},
            "work": {"windows_a_stream": n_w,
                     "detections_a_stream": sum(len(found[th][0]) for th in st["flags"].detection_thresholds),
                     "walls_s": [round(w, 4) for w in walls]}}


def reference_rows(cell, st, num_windows: int, precisions=(exact,), block: int = 2048):
    """The reference model's softmax rows of the stream's first
    ``num_windows`` windows from the reference frontend, in each of
    ``precisions`` (float32 numpy), and those features."""
    width, depth = dims(cell.config)
    ref = Model(st["state"], "transfer", width, depth)
    feats, rows = [], [[] for _ in precisions]
    with torch.no_grad():
        for _, f in ref_frontend.stream_window_features(st["samples"], num_windows, block=block):
            feats.append(f)
            x = torch.from_numpy(f).to(cell.device)[..., None]
            for out, precision in zip(rows, precisions):
                with precision():
                    out.append(ref(x).cpu().numpy())
    return [np.concatenate(r) for r in rows], np.concatenate(feats)


def num_windows(samples: np.ndarray) -> int:
    """The stream's windows: one each 20 ms hop that leaves a whole second."""
    return (samples.shape[0] - audio.SR - 1) // 320 + 1


def tf32_readings(cell, st) -> Dict[str, float]:
    """The control's numbers: the reference in TF32 put in the program's
    place, against the reference in float32."""
    (rows, tf), _ = reference_rows(cell, st, num_windows(st["samples"]), (exact, tf32))
    return {"softmax_gap": float(np.max(np.abs(tf - rows)))}


def check(cell, st, out) -> Dict:
    limits = cell.workload["limits"]
    outputs = st.pop("outputs")
    samples = st["samples"]
    flags = st["flags"]
    chunks = st.pop("features")
    prog_feats = np.concatenate([c.cpu().numpy() for c in chunks]) if chunks else np.zeros((0, 49, 40), np.float32)
    del chunks
    st.pop("model")
    if cell.device != "cpu":
        torch.cuda.empty_cache()
    (ref_rows,), ref_feats = reference_rows(cell, st, num_windows(samples))
    frontend_mismatch = int(np.count_nonzero(prog_feats != ref_feats)) if prog_feats.shape == ref_feats.shape else -1
    gap = max(float(np.max(np.abs(rows - ref_rows))) if rows.shape == ref_rows.shape else float("inf")
              for _, rows in outputs)
    times_ms = [int(off * 1000 / audio.SR) for off in range(0, samples.shape[0] - audio.SR, 320)]
    seen, mismatched = {}, 0
    for found, rows in outputs:
        key = hashlib.sha1(rows.tobytes()).hexdigest()
        if key not in seen:
            seen[key] = ref_detector.detections_by_threshold(rows, times_ms[: rows.shape[0]], flags.detection_thresholds,
                                                             target_name=KEYWORD)
        expect = seen[key]
        mismatched += sum(found[th][0] != expect[float(th)] for th in flags.detection_thresholds)
    return {
        "frontend_mismatch": verdict(frontend_mismatch, limits["frontend_mismatch"], exact=True),
        "softmax_gap": verdict(gap, limits["softmax_gap"]),
        "detections_mismatch": verdict(mismatched, limits["detections_mismatch"], exact=True),
    }

