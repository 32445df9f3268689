#!/usr/bin/env python3
"""What moves phase i's card-vs-CPU pretraining gate between checkouts.

    python3 gate_drift.py --tree DIR [--deterministic]

Runs in the checkout DIR (its ``multilingual_kws_tpu_torch`` and its
``chip_smoke.py``) on one card: builds phase i's seeded 761-label corpus,
runs ``pretrain()`` at float32 as phase i does (under an NCCL group of one
rank), and then draws the gate's batch from the dataset ``pretrain()``
returned, as phase i does, after ADVANCES resident epochs of that dataset's
device draws (``PT_STEPS`` calls of ``_train_device`` on one host draw each;
phase i's step timing loop made 7 before the gate, up to the commit that
graphed the epochs, and none after). For each advance it prints the batch's
hash, and for 0 and 7 the checkout's own ``pretrain_gate`` on that batch:
the state and batch hashes, the loss on both sides, each tensor's max
|card - CPU| over its largest |CPU| (the five largest and the median).
``--deterministic`` runs the gates under cuDNN's deterministic algorithms.
One JSON line per gate.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ADVANCES = range(10)
GATED = (0, 7)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("gate_drift: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from multilingual_kws_tpu_torch.data.manifests import label_from_parent_dir
    from multilingual_kws_tpu_torch.models.kws_model import lecun_init_, make_embedding_model
    from multilingual_kws_tpu_torch.parallel import mesh
    from multilingual_kws_tpu_torch.train.pretrain import PretrainConfig, pretrain
    from multilingual_kws_tpu_torch.utils.wav import write_wav

    assert Path(cs.__file__).resolve().parent == tree, cs.__file__
    with tempfile.TemporaryDirectory() as work:
        corpus = cs.pretrain_corpus(Path(work) / "pretrain_corpus", 11, write_wav)
        train_labels = [label_from_parent_dir(f) for f in corpus["train"]]
        mesh.initialize_distributed("nccl", init_method=f"tcp://localhost:{cs.free_port()}", world_size=1, rank=0)
        group = mesh.default_group()
        model0 = lecun_init_(make_embedding_model(cs.PT_WORDS + 1, device="cpu", compute_dtype="float32"), seed=0)
        config = PretrainConfig(num_labels=cs.PT_WORDS + 1, batch_size=cs.PT_BATCH, num_epochs=cs.PT_EPOCHS,
                                steps_per_epoch=cs.PT_STEPS, bn_calibration_batches=2, compute_dtype="float32",
                                device="cuda")
        _, _, ds = pretrain(corpus["train"], corpus["val"], corpus["words"], corpus["bg_dir"], config=config,
                            model=model0, verbose=0)
        bank = ds.build_resident_bank(corpus["train"])
        start = ds.host_rng.bit_generator.state, ds.gen.get_state()
        batches, hashes = {}, {}
        for advance in ADVANCES:
            ds.host_rng.bit_generator.state = start[0]
            ds.gen.set_state(start[1])
            if advance:
                draws = list(ds.host_train_indices(corpus["train"], cs.PT_BATCH, cs.PT_STEPS, bank,
                                                   labels=train_labels, single_target=False))
                idx, _, sil = ds._put_batch(tuple(np.stack(a) for a in zip(*draws)))
                for _ in range(advance):
                    for i in range(cs.PT_STEPS):
                        ds._train_device(bank["bank"], idx[i], sil[i])
            specs, labels = next(ds.train_batches_resident(corpus["train"], cs.PT_BATCH, 1, labels=train_labels,
                                                           single_target=False, bank=bank))
            batches[advance] = specs.clone(), labels.clone()
            h = hashlib.sha1()
            for t in batches[advance]:
                h.update(t.detach().cpu().contiguous().numpy().tobytes())
            hashes[advance] = h.hexdigest()[:16]
        print(json.dumps({"tree": str(tree), "batch_hash_by_advance": hashes}), flush=True)
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = args.deterministic
        for advance in GATED:
            gate = cs.pretrain_gate(torch, *batches[advance], group)
            errs = gate["errors"]
            line = json.dumps({
                "tree": os.path.relpath(tree, Path(__file__).resolve().parent),
                "advance": advance, "deterministic": args.deterministic, "state": gate["state"],
                "batch": gate["batch"], "loss": gate["loss"], "max_err": max(errs.values()),
                "median_err": float(np.median(list(errs.values()))),
                "top5": dict(sorted(errs.items(), key=lambda kv: -kv[1])[:5]),
                "stem": errs["trunk.stem.conv.weight"],
            })
            print(line, flush=True)
        torch.backends.cudnn.deterministic = prev
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
