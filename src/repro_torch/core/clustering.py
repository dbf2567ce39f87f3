"""Local knowledge clustering (paper §IV.B).

Devices upload low-rank data embeddings e_n alongside their trained
on-device LLMs.  The server builds the cosine-similarity matrix Π
(Eq. 6) and groups devices into K local knowledge domains with KMeans.

The paper weight-averages the models inside each cluster (Fig. 4), which
requires identical parameter structure — it implicitly assumes "models of
the same type" end up together.  We make that explicit: clustering is
*architecture-constrained* — after KMeans on embeddings, devices whose
architecture differs from their cluster's majority architecture are
re-assigned to the nearest (by centroid cosine) cluster whose majority
architecture matches theirs; if none exists, they form the seed of a
spill cluster.  This keeps every proxy model well-defined while
preserving the embedding-driven domain structure.

No sklearn dependency: spherical k-means++ in numpy.

A copy of ``repro.core.clustering`` (numpy only, nothing changed), so
labels, centroids and spill clusters are bit-identical to the
reference's on the same embeddings and seed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


def cosine_similarity_matrix(embeddings: np.ndarray) -> np.ndarray:
    """Π = [π_{n1,n2}] (Eq. 6)."""
    e = embeddings / (np.linalg.norm(embeddings, axis=1, keepdims=True) + 1e-9)
    return e @ e.T


def _kmeans_pp_init(rng, e: np.ndarray, k: int) -> np.ndarray:
    n = len(e)
    centroids = [e[rng.integers(n)]]
    for _ in range(1, k):
        d = np.min(
            [1.0 - e @ c for c in centroids], axis=0)  # cosine distance
        d = np.maximum(d, 0.0)
        probs = d / d.sum() if d.sum() > 0 else np.full(n, 1.0 / n)
        centroids.append(e[rng.choice(n, p=probs)])
    return np.stack(centroids)


def spherical_kmeans(embeddings: np.ndarray, k: int, *, seed: int = 0,
                     iters: int = 50):
    """Returns (labels (N,), centroids (K, D))."""
    rng = np.random.default_rng(seed)
    e = embeddings / (np.linalg.norm(embeddings, axis=1, keepdims=True) + 1e-9)
    k = min(k, len(e))
    c = _kmeans_pp_init(rng, e, k)
    labels = np.zeros(len(e), np.int32)
    for _ in range(iters):
        sims = e @ c.T
        new_labels = np.argmax(sims, axis=1).astype(np.int32)
        if np.array_equal(new_labels, labels) and _ > 0:
            break
        labels = new_labels
        for j in range(k):
            members = e[labels == j]
            if len(members):
                m = members.mean(axis=0)
                c[j] = m / (np.linalg.norm(m) + 1e-9)
            else:  # re-seed empty cluster at the farthest point
                far = np.argmin(np.max(e @ c.T, axis=1))
                c[j] = e[far]
    return labels, c


@dataclasses.dataclass
class ClusterResult:
    labels: np.ndarray            # (N,) cluster id per device
    centroids: np.ndarray         # (K, D)
    similarity: np.ndarray        # (N, N) Π matrix
    members: List[List[int]]      # device ids per cluster


def cluster_devices(embeddings: np.ndarray, k: int, *,
                    arch_ids: Optional[Sequence[int]] = None,
                    seed: int = 0) -> ClusterResult:
    """KMeans over data embeddings, architecture-constrained (see module doc)."""
    sim = cosine_similarity_matrix(embeddings)
    labels, centroids = spherical_kmeans(embeddings, k, seed=seed)
    k = len(centroids)

    if arch_ids is not None:
        arch_ids = np.asarray(arch_ids)
        e = embeddings / (np.linalg.norm(embeddings, axis=1, keepdims=True) + 1e-9)
        # majority arch per cluster
        majority = {}
        for j in range(k):
            m = arch_ids[labels == j]
            majority[j] = np.bincount(m).argmax() if len(m) else -1
        sims = e @ centroids.T
        for n in range(len(labels)):
            if majority[labels[n]] in (-1, arch_ids[n]):
                continue
            # nearest cluster with matching majority arch
            compatible = [j for j in range(k) if majority[j] == arch_ids[n]]
            if compatible:
                labels[n] = compatible[int(np.argmax(sims[n, compatible]))]
            else:
                # seed a spill cluster from the emptiest slot
                j = int(np.argmin(np.bincount(labels, minlength=k)))
                labels[n] = j
                majority[j] = arch_ids[n]

    members = [sorted(np.nonzero(labels == j)[0].tolist()) for j in range(k)]
    return ClusterResult(labels, centroids, sim, members)
