"""Acceptance metrics for comparing pullback bases (counterpart of
diffusion_pullback_tpu/geometry/metrics.py, numpy only).

The criterion is singular-vector cosine ≥ 0.99 against a reference,
sign-aligned and compared per σ-gap group: directions whose singular
values cluster are defined only up to a rotation inside their span.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class BasisComparison(NamedTuple):
    per_direction_cos: np.ndarray   # |cos| per matched direction
    subspace_cos: np.ndarray        # principal-angle cosines of the top-k spans
    sigma_rel_err: np.ndarray       # |σ_a - σ_b| / σ_b
    gap_groups: Sequence[Sequence[int]]  # indices grouped by σ-clusters


def _gap_groups(s: np.ndarray, rel_gap: float = 0.05):
    """Group indices whose singular values lie within rel_gap of their
    neighbour's."""
    groups, cur = [], [0]
    for i in range(1, len(s)):
        if abs(s[i - 1] - s[i]) <= rel_gap * max(abs(s[i - 1]), 1e-12):
            cur.append(i)
        else:
            groups.append(cur)
            cur = [i]
    groups.append(cur)
    return groups


def compare_bases(vT_a, s_a, vT_b, s_b, rel_gap: float = 0.05) -> BasisComparison:
    """Compare (s, vT) of two runs over their common top k. Each direction's
    cosine is a principal-angle cosine of its σ-gap group's spans (groups
    from ``s_b``), so sign flips and rotations inside a cluster pass."""
    vT_a, vT_b = np.asarray(vT_a, np.float64), np.asarray(vT_b, np.float64)
    s_a, s_b = np.asarray(s_a, np.float64), np.asarray(s_b, np.float64)
    k = min(len(s_a), len(s_b), vT_a.shape[0], vT_b.shape[0])
    vT_a, vT_b, s_a, s_b = vT_a[:k], vT_b[:k], s_a[:k], s_b[:k]

    groups = _gap_groups(s_b, rel_gap)
    per_dir = np.zeros(k)
    for g in groups:
        idx = [i for i in g if i < k]
        if not idx:
            continue
        qa = np.linalg.qr(vT_a[idx].T)[0]
        qb = np.linalg.qr(vT_b[idx].T)[0]
        cos = np.linalg.svd(qa.T @ qb, compute_uv=False)
        for j, i in enumerate(sorted(idx)):
            per_dir[i] = cos[min(j, len(cos) - 1)]

    qa = np.linalg.qr(vT_a.T)[0]
    qb = np.linalg.qr(vT_b.T)[0]
    sub = np.linalg.svd(qa.T @ qb, compute_uv=False)
    rel = np.abs(s_a - s_b) / np.maximum(np.abs(s_b), 1e-12)
    return BasisComparison(per_dir, sub, rel, groups)


def passes_acceptance(cmp: BasisComparison, cos_min: float = 0.99,
                      sigma_rtol: float = 0.05) -> bool:
    """Every gap-grouped direction cosine ≥ cos_min and every singular
    value within sigma_rtol."""
    return bool(cmp.per_direction_cos.min() >= cos_min
                and cmp.sigma_rel_err.max() <= sigma_rtol)
