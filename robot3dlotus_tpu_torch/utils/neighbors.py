"""Host neighbour analytics in numpy only (the port's copy of
robot3dlotus_tpu/utils/neighbors.py): brute-force kNN distances, DBSCAN
and the Local Outlier Factor, in place of upstream's sklearn calls (DBSCAN
in the VLM pipeline, LOF for the training datasets' rm_pc_outliers).

They run on per-object or per-keystep clouds of hundreds to a few
thousand points, so exact O(N^2) brute force needs no tree and no
dependency. Semantics are sklearn's:

* `dbscan_labels` follows sklearn's `dbscan_inner` expansion (a LIFO
  stack from each unlabelled core point in index order), so labels,
  including the order-dependent border points, are equal, not merely
  equal up to a permutation.
* `local_outlier_factor_mask` is LocalOutlierFactor.fit_predict with
  contamination="auto": lrd with sklearn's 1e-10 regulariser, inliers
  where negative_outlier_factor_ >= -1.5.
* `knn_dists` gives the sorted distances to the k nearest neighbours,
  self excluded.

Outputs are bit-equal to the JAX package's (tests/test_torch_port_data.py).
"""
from __future__ import annotations

import numpy as np

__all__ = ["knn_dists", "dbscan_labels", "local_outlier_factor_mask"]


def _pairwise_sq_dists(x: np.ndarray, chunk: int = 2048) -> np.ndarray:
    """Exact squared euclidean distance matrix, row-chunked to bound the
    temporary at chunk*N instead of N*N*dim."""
    x = np.ascontiguousarray(x, np.float64)
    n = len(x)
    sq = (x * x).sum(1)
    out = np.empty((n, n), np.float64)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        g = x[s:e] @ x.T
        np.maximum(sq[s:e, None] + sq[None, :] - 2.0 * g, 0.0, out=out[s:e])
    return out


def knn_dists(x: np.ndarray, k: int) -> np.ndarray:
    """(N, k) sorted euclidean distances to the k nearest neighbors of each
    row, self excluded. Requires k < N."""
    x = np.asarray(x, np.float64)
    n = len(x)
    if not 0 < k < n:
        raise ValueError(f"knn_dists: need 0 < k < N, got k={k}, N={n}")
    d2 = _pairwise_sq_dists(x)
    np.fill_diagonal(d2, np.inf)
    idx = np.argpartition(d2, k - 1, axis=1)[:, :k]
    part = np.take_along_axis(d2, idx, axis=1)
    part.sort(axis=1)
    return np.sqrt(part)


def _knn(x: np.ndarray, k: int):
    """(dists, idx) of the k nearest neighbors (self excluded), sorted by
    distance with index as the tie-breaker — sklearn's kneighbors order."""
    d2 = _pairwise_sq_dists(x)
    np.fill_diagonal(d2, np.inf)
    # lexsort-equivalent: argsort is stable, so equal distances keep
    # ascending index order, matching sklearn's brute kneighbors
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    d = np.sqrt(np.take_along_axis(d2, idx, axis=1))
    return d, idx


def dbscan_labels(x: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN cluster labels (noise = -1), exactly matching
    sklearn.cluster.DBSCAN(eps, min_samples, metric='euclidean').fit().labels_.

    Core point: >= min_samples points within eps (self included). Expansion
    mirrors sklearn's dbscan_inner: scan points in index order; from each
    unlabeled core point run a DFS (LIFO stack) over eps-neighborhoods,
    labeling every reached unlabeled point; only core points extend the
    frontier. Border points therefore join the first cluster that reaches
    them, in the same order sklearn assigns them."""
    x = np.asarray(x, np.float64)
    n = len(x)
    if n == 0:
        return np.empty(0, np.int64)
    d2 = _pairwise_sq_dists(x)
    within = d2 <= float(eps) ** 2  # diagonal True: self counts
    n_within = within.sum(1)
    is_core = n_within >= int(min_samples)
    neighborhoods = [np.nonzero(row)[0] for row in within]

    labels = np.full(n, -1, np.int64)
    label_num = 0
    stack: list[int] = []
    for start in range(n):
        if labels[start] != -1 or not is_core[start]:
            continue
        i = start
        while True:
            if labels[i] == -1:
                labels[i] = label_num
                if is_core[i]:
                    for v in neighborhoods[i]:
                        if labels[v] == -1:
                            stack.append(int(v))
            if not stack:
                break
            i = stack.pop()
        label_num += 1
    return labels


def local_outlier_factor_mask(x: np.ndarray, n_neighbors: int = 20) -> np.ndarray:
    """Boolean inlier mask == (LocalOutlierFactor(n_neighbors).fit_predict(x)
    == 1) with sklearn's contamination='auto' threshold.

    LOF(p) = mean_o lrd(o) / lrd(p) over p's k nearest neighbors, where
    lrd(p) = 1 / (mean_o max(k_dist(o), d(p, o)) + 1e-10) — the 1e-10 is
    sklearn's duplicate-point regularizer. Inlier iff -LOF >= -1.5."""
    x = np.asarray(x, np.float64)
    n = len(x)
    # sklearn clamps n_neighbors to N-1 (with a warning); same behavior
    k = max(1, min(int(n_neighbors), n - 1))
    if n <= 1:
        return np.ones(n, bool)
    dist, idx = _knn(x, k)
    k_dist = dist[:, -1]  # distance to the k-th neighbor
    reach = np.maximum(k_dist[idx], dist)  # (N, k)
    lrd = 1.0 / (reach.mean(1) + 1e-10)
    lof = lrd[idx].mean(1) / lrd
    return -lof >= -1.5
