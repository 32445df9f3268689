"""Embedding-distance data filtering: find outlier or bad crowdsourced clips.

Counterpart of ``multilingual_kws_tpu/analysis/distance_filtering.py``
(reference embedding/distance_filtering.py): featurize ~50 training clips,
k-means their 192-d embedding vectors (5 clusters), and sort the other clips
by L2 distance to the nearest center; far-away clips are candidates for
removal.

The embedding is the port model's ``embed`` (no Keras layer surgery at
"dense_2"), and k-means runs in torch on the points' device: kmeans++
seeding drawn from an explicit ``torch.Generator`` (``kmeans_seed``), then
Lloyd updates (``kmeans_lloyd``; an empty cluster keeps its center), both in
one device program (``kmeans_fit``, the JAX package's jitted ``kmeans_fit``:
on the card a CUDA graph). torch cannot reproduce ``jax.random``, so the
seeded centers differ from the JAX package's; started from the same centers,
the Lloyd updates agree.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from .. import exact_float32, resolve_device
from ..train.evaluate import featurize_files
from ..train.graphs import ProgramGraphs, eval_embed, resolved_device, serve


def make_embedding_fn(model: torch.nn.Module) -> Callable:
    """(B, 49, 40, 1) specs (numpy or a tensor) -> (B, 192) float32 numpy
    embeddings, computed by ``model.embed`` in eval mode on the model's
    device: its embedding program (``train/graphs.serve``; on a card a
    CUDA graph a batch shape, after one eager call, as the JAX package jits
    it). ``model`` is a ``KWSEmbeddingModel`` or ``KWSTransferModel``."""
    program = serve(model, eval_embed)

    def embed(specs) -> np.ndarray:
        return program(torch.as_tensor(specs, dtype=torch.float32)).float().cpu().numpy()

    return embed


def _sq_dists(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N, K) squared L2 distances, as the difference's squares summed."""
    return ((points[:, None] - centers[None]) ** 2).sum(-1)


def kmeans_seed(points: torch.Tensor, n_clusters: int, generator: torch.Generator) -> torch.Tensor:
    """kmeans++ seeding of (N, D) points -> (K, D) centers: the first center
    uniformly, each next one with probability proportional to its squared
    distance to the nearest center so far (uniformly when every point lies on
    a center). ``generator`` lives on the points' device. No host sync, so
    a CUDA graph holds it: the uniform fallback is a ``torch.where`` on the
    weights."""
    n = points.shape[0]
    first = torch.randint(n, (1,), generator=generator, device=points.device)
    centers = points[first]
    for _ in range(1, n_clusters):
        d2 = _sq_dists(points, centers).min(dim=1).values
        weights = torch.where(d2.sum() > 0, d2, torch.ones_like(d2))
        idx = torch.multinomial(weights, 1, generator=generator)
        centers = torch.cat([centers, points[idx]])
    return centers


def kmeans_lloyd(points: torch.Tensor, centers: torch.Tensor, n_iters: int = 50) -> torch.Tensor:
    """``n_iters`` Lloyd updates of (K, D) centers over (N, D) points: assign
    each point to its nearest center, move each center to its points' mean;
    a center with no points stays where it is."""
    k = centers.shape[0]
    with exact_float32():
        for _ in range(n_iters):
            onehot = torch.nn.functional.one_hot(_sq_dists(points, centers).argmin(dim=1), k).to(points.dtype)
            counts = onehot.sum(0)[:, None]
            sums = onehot.T @ points
            centers = torch.where(counts > 0, sums / counts.clamp(min=1), centers)
    return centers


@functools.lru_cache(maxsize=8)
def _fit_program(n_clusters: int, n_iters: int) -> ProgramGraphs:
    return ProgramGraphs(lambda points, generator: kmeans_lloyd(points, kmeans_seed(points, n_clusters, generator),
                                                                n_iters))


def kmeans_fit(points: torch.Tensor, n_clusters: int, generator: torch.Generator, n_iters: int = 50) -> torch.Tensor:
    """K-means of (N, D) points -> (K, D) centers: ``kmeans_seed`` from
    ``generator``, then ``n_iters`` of ``kmeans_lloyd``, as one device
    program, the counterpart of the JAX package's jitted ``kmeans_fit``
    (one executable per static ``n_clusters`` and ``n_iters`` and points'
    shape). On the card a CUDA graph per (N, D, K, n_iters) and generator,
    after one eager call (``train/graphs.ProgramGraphs``; the generator is
    registered with it, so a replay draws from its offset at the time); on
    the CPU the two functions."""
    return _fit_program(n_clusters, n_iters)(points, generator)


@functools.lru_cache(maxsize=None)
def _generator(device: torch.device) -> torch.Generator:
    """``cluster_and_sort``'s generator on ``device``, seeded by each call:
    one object, so that its k-means program replays a graph from the second
    call on (a program's key holds its generators)."""
    return torch.Generator(device=device)


def cluster_and_sort(
    keyword_samples: Sequence[str],
    embedding_fn: Callable[[np.ndarray], np.ndarray],
    seed: int = 123,
    n_train: int = 50,
    n_clusters: int = 5,
    device="cuda",
) -> Dict:
    """Reference cluster_and_sort (distance_filtering.py:30-83): features
    and k-means on ``device``.

    Returns dict(sorted_clips, cluster_centers, distances, train_clips), the
    evaluation clips sorted ascending by L2 distance to the nearest center.
    """
    dev = resolve_device(device)
    if len(keyword_samples) <= n_train:
        raise ValueError(f"{n_train} training clips need more than {len(keyword_samples)} samples")
    rng = np.random.RandomState(seed)  # reference parity: RandomState permutation
    kwdata = rng.permutation(np.asarray(keyword_samples, dtype=object))
    train_clips = kwdata[:n_train]
    eval_clips = kwdata[n_train:]

    train_vecs = embedding_fn(featurize_files(list(train_clips), device=dev)[..., None])
    gen = _generator(resolved_device(dev))
    gen.manual_seed(seed)
    points = torch.as_tensor(train_vecs, device=dev)
    centers = kmeans_fit(points, n_clusters, gen).cpu().numpy()

    eval_vecs = embedding_fn(featurize_files(list(eval_clips), device=dev)[..., None])
    l2 = np.linalg.norm(centers[None] - eval_vecs[:, None], axis=-1)
    closest = l2.min(axis=1)
    order = np.argsort(closest)
    return dict(
        sorted_clips=eval_clips[order],
        cluster_centers=centers,
        distances=closest[order],
        train_clips=train_clips,
    )
