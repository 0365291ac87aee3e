"""Host-side agglomerative clustering of speaker embeddings.

A copy of the JAX package's ``models/diarization/clustering.py`` (numpy
and scipy, no JAX): average linkage over cosine distance cut at a
threshold, min/max speaker-count constraints, and pyannote-3.1's
``min_cluster_size`` dissolution.  It runs on the host, on a few hundred
to a few thousand crops.
"""
from __future__ import annotations

import numpy as np


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)


def cosine_distances(x: np.ndarray) -> np.ndarray:
    x = _normalize(x)
    return np.clip(1.0 - x @ x.T, 0.0, 2.0)


def agglomerative_cluster(
    embeddings: np.ndarray,
    threshold: float = 0.7,
    min_clusters: int = 1,
    max_clusters: int | None = None,
    min_cluster_size: int = 0,
) -> np.ndarray:
    """(n, d) embeddings -> (n,) integer labels (0..k-1, size-ordered).

    Average linkage over cosine distance via scipy; clusters are cut at
    `threshold`, then merged/split to satisfy the min/max constraints.

    min_cluster_size > 1 dissolves clusters with fewer members
    (pyannote-3.1's AgglomerativeClustering option): their embeddings
    reassign to the nearest surviving cluster's centroid in cosine space —
    stray crops (coughs, cross-talk slivers) stop minting phantom
    speakers.  When no cluster reaches the size, the largest survives.
    """
    n = len(embeddings)
    if n == 0:
        return np.zeros((0,), np.int64)
    if n == 1:
        return np.zeros((1,), np.int64)

    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    dist = cosine_distances(embeddings)
    condensed = squareform(dist, checks=False)
    z = linkage(condensed, method="average")
    labels = fcluster(z, t=threshold, criterion="distance") - 1

    k = labels.max() + 1
    if max_clusters is not None and k > max_clusters:
        labels = fcluster(z, t=max_clusters, criterion="maxclust") - 1
        k = labels.max() + 1

    # min_clusters re-cut BEFORE the min_cluster_size dissolution: cutting
    # from the raw linkage afterwards would resurrect exactly the stray
    # clusters the dissolution removed
    if k < min_clusters and n >= min_clusters:
        labels = fcluster(z, t=min_clusters, criterion="maxclust") - 1
        k = labels.max() + 1

    if min_cluster_size > 1:
        ids, counts = np.unique(labels, return_counts=True)
        large = ids[counts >= min_cluster_size]
        floor = max(min_clusters, 1)
        if large.size < floor:
            # never dissolve below min_clusters: top up with the largest
            # small clusters
            order = ids[np.argsort(-counts, kind="stable")]
            large = order[:floor]
        small = ~np.isin(labels, large)
        if small.any():
            x = _normalize(embeddings)
            cents = _normalize(np.stack([x[labels == c].mean(0) for c in large]))
            labels = labels.copy()
            labels[small] = large[np.argmax(x[small] @ cents.T, axis=1)]

    return _relabel_by_size(labels)


def _relabel_by_size(labels: np.ndarray) -> np.ndarray:
    """Renumber clusters so 0 is the most-talkative speaker, etc."""
    ids, counts = np.unique(labels, return_counts=True)
    order = ids[np.argsort(-counts, kind="stable")]
    mapping = {old: new for new, old in enumerate(order)}
    return np.asarray([mapping[x] for x in labels], np.int64)
