"""Tutorial: the 5-shot KWS workflow, end to end, on the port's API.

The port's counterpart of ``examples/tutorial.py``, which reproduces the
reference's intro notebook (``multilingual_kws_intro_tutorial.ipynb``)
step by step:

  1.  data layout: an MSWC-microset-style clips tree, a GSC-style
      ``_background_noise_`` and an ``unknown_files.txt`` manifest
      (cells 5-9);
  2.  featurization: ``file2spec``, one clip -> 49x40 features (cell 13);
  3.  embedding extraction: the base model's 192-d embedding (the
      reference's ``dense_2`` layer surgery; here ``model.embed``,
      cells 17-19);
  4.  a 2-D projection of the embeddings by keyword (UMAP when installed,
      PCA otherwise; cells 21-26);
  5.  5-shot ``transfer_learn`` with the notebook's arguments (cell 28);
  6.  argmax accuracy on held-out target clips (cell 30) and on non-target
      clips (cell 36).

On a synthetic microset (no downloads), on the card:

    python -m multilingual_kws_tpu_torch.examples.tutorial --workdir W
    python -m multilingual_kws_tpu_torch.examples.tutorial --workdir W --tiny --device cpu
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .. import resolve_device


def make_synthetic_microset(workdir: Path):
    """MSWC-microset-style layout: <lang>/clips/<word>/*.wav, background
    noise and an unknown manifest (the tutorial's downloads, cell 5)."""
    from .synth import make_corpus

    return make_corpus(workdir / "en" / "clips", clips_per_word=12)


def step_featurize(files, settings=None, device="cuda"):
    """Cell 13: file2spec, one clip -> (49, 40) float32 features."""
    from ..data.dataset import file2spec
    from ..settings import standard_microspeech_model_settings

    settings = settings or standard_microspeech_model_settings(3)
    spec = file2spec(settings, files[0], device=device)
    print(f"file2spec: {files[0]} -> {spec.shape} (range {spec.min():.2f}..{spec.max():.2f})")
    return settings


def step_embeddings(base_model_dir, clips_by_word, model=None, device="cuda"):
    """Cells 17-19: 192-d embedding vectors from the base model (the
    reference truncates the Keras model at "dense_2"; here the embedding is
    the model's ``embed``, through its embedding program). ``model``: the
    base model's architecture when it is not the checkpoint's sized B0."""
    from ..analysis.distance_filtering import make_embedding_fn
    from ..models.kws_model import KWSEmbeddingModel
    from ..train import checkpoints as ckpt
    from ..train.evaluate import featurize_files

    dev = resolve_device(device)
    state, meta = ckpt.load_model(base_model_dir, dev)
    if model is None:
        model = KWSEmbeddingModel(int(meta["num_labels"]), ckpt.sized_trunk(meta))
    model = model.to(dev).eval()
    model.load_state_dict(state, strict=True)
    words, vecs = [], []
    embed = make_embedding_fn(model)
    for word, files in clips_by_word.items():
        vecs.append(embed(featurize_files(files, device=dev)[..., None]))
        words.extend([word] * len(files))
    embeddings = np.concatenate(vecs)
    print(f"embeddings: {embeddings.shape} ({embeddings.shape[1]}-d, reference 'dense_2' output)")
    return embeddings, words


def step_projection(embeddings, words, dest):
    """Cells 21-26: 2-D projection by keyword (UMAP, else PCA), plotted to
    ``dest`` when matplotlib is installed."""
    scaled = (embeddings - embeddings.mean(0)) / (embeddings.std(0) + 1e-8)
    try:
        import umap

        proj, method = umap.UMAP().fit_transform(scaled), "UMAP"
    except ImportError:
        _, _, vt = np.linalg.svd(scaled, full_matrices=False)  # the top two principal directions
        proj, method = scaled @ vt[:2].T, "PCA"
    print(f"projection: {method}, {proj.shape}")
    try:
        import matplotlib
    except ImportError:
        print("(no plot: matplotlib is not installed)")
        return proj
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    for w in sorted(set(words)):
        m = np.asarray([x == w for x in words])
        ax.scatter(proj[m, 0], proj[m, 1], label=w, s=12)
    ax.legend()
    ax.set_title(f"keyword embeddings ({method})")
    fig.savefig(dest, dpi=100)
    plt.close(fig)
    print(f"wrote {dest}")
    return proj


def step_transfer_learn(keyword, five_samples, dev_samples, unknown_files, background_noise, base_model_dir,
                        model=None, device="cuda"):
    """Cell 28: the tutorial's transfer_learn call."""
    from ..settings import standard_microspeech_model_settings
    from ..train.finetune import transfer_learn

    result = transfer_learn(
        target=keyword, train_files=five_samples, val_files=dev_samples, unknown_files=unknown_files,
        num_epochs=4, num_batches=1, batch_size=64, primary_lr=0.001, backprop_into_embedding=False,
        embedding_lr=0, model_settings=standard_microspeech_model_settings(3), base_model_path=base_model_dir,
        unknown_percentage=50.0, bg_datadir=background_noise, model=model, seed=0, verbose=0, device=device,
    )
    print(f"transfer_learn: val_accuracy={result.details['val_accuracy']:.2f}")
    return result


def step_test_accuracy(result, test_samples, non_target_samples, device="cuda"):
    """Cells 30 and 36: argmax accuracy on target and non-target clips
    (class 0 silence, 1 unknown, 2 the target)."""
    from ..train.evaluate import featurize_files

    predict = result.predict_fn()

    def classes(files):
        return np.argmax(predict(featurize_files(files, device=device)[..., None]).cpu().numpy(), axis=1)

    target_acc = float((classes(test_samples) == 2).mean())
    print(f"Test accuracy on testset: {target_acc:0.2f}")
    nontarget_acc = float((classes(non_target_samples) == 1).mean())
    print(f"Estimated accuracy on non-target samples: {nontarget_acc:0.2f}")
    return target_acc, nontarget_acc


def run_tutorial(workdir: Path, keyword: str = "alpha", shots: int = 5, tiny: bool = False, device="cuda"):
    """The notebook's path on a synthetic microset; returns a summary
    (val_accuracy, test_accuracy, nontarget_accuracy, embedding_dim).
    ``tiny`` takes narrow models (seconds on a CPU); otherwise the
    full-width EfficientNetB0."""
    from ..train import checkpoints as ckpt
    from ..train.pretrain import PretrainConfig, pretrain
    from .synth import tiny_embedding_model, tiny_transfer_model

    dev = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    corpus = make_synthetic_microset(workdir)
    words = ["bravo", "charlie"]
    emb_model = xfer_model = None  # pretrain's and transfer_learn's full-width B0
    if tiny:
        emb_model, xfer_model = tiny_embedding_model(4, dev), tiny_transfer_model(dev)

    # stand-in for the released checkpoint (cell 5): pretrain an embedding
    # model on the other words
    base_dir = workdir / "embedding_model"
    if not (base_dir / "kws_metadata.json").exists():
        model, _, _ = pretrain(
            [f for w in words for f in corpus[w][:10]], [f for w in words for f in corpus[w][10:]],
            commands=words, background_data_dir=corpus["bg_dir"], unknown_files=corpus["unknown_files"],
            config=PretrainConfig(num_labels=4, batch_size=16, num_epochs=5, learning_rate=3e-3,
                                  silence_percentage=10, unknown_percentage=15, shuffle_seed=0, steps_per_epoch=12,
                                  device=str(dev)),
            verbose=0, model=emb_model,
        )
        ckpt.save_model(base_dir, model, {"kind": "embedding", "num_labels": 4, **ckpt.trunk_metadata(model.trunk)})

    step_featurize(corpus[keyword], device=dev)
    embeddings, labels = step_embeddings(base_dir, {w: corpus[w][:8] for w in [keyword] + words},
                                         model=emb_model, device=dev)
    step_projection(embeddings, labels, workdir / "embeddings.png")

    result = step_transfer_learn(keyword, corpus[keyword][:shots], corpus[keyword][shots : shots + 4],
                                 corpus["unknown_files"], corpus["bg_dir"], base_dir, model=xfer_model, device=dev)
    non_target = [f for w in words for f in corpus[w][-4:]]
    target_acc, nontarget_acc = step_test_accuracy(result, corpus[keyword][shots + 4 :], non_target, device=dev)
    return dict(val_accuracy=float(result.details["val_accuracy"]), test_accuracy=target_acc,
                nontarget_accuracy=nontarget_acc, embedding_dim=int(embeddings.shape[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m multilingual_kws_tpu_torch.examples.tutorial")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--keyword", default="alpha")
    ap.add_argument("--shots", type=int, default=5)
    ap.add_argument("--tiny", action="store_true", help="narrow models (a quick CPU walk-through)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    summary = run_tutorial(Path(args.workdir), keyword=args.keyword, shots=args.shots, tiny=args.tiny,
                           device=args.device)
    print("summary:", summary)
    return summary


if __name__ == "__main__":
    main()
