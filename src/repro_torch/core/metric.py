"""Metric generality via input-side reductions to squared l2 (the JAX
package's ``core/metric.py`` explains the identities):

  * l2 — the identity;
  * cosine — row-normalize: on unit rows, |q - x|^2 = 2 - 2 cos(q, x);
  * mips — append sqrt(M^2 - |x|^2) to every corpus row (M = max row
    norm), so ascending l2 is descending inner product.

``transform_corpus`` runs once where rows enter a build or a store,
``transform_queries`` once per batch at the search boundary; the kernels
see plain rows and plain squared l2. ``similarity_from_dist`` turns the
transformed-space distances back into cosine or inner-product values.
"""
from __future__ import annotations

import warnings

import torch

METRICS = ("l2", "cosine", "mips")

_EPS = 1e-12   # zero-row guard: a zero row normalizes to zero, not NaN


def check_metric(metric: str) -> str:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of "
                         f"{METRICS}")
    return metric


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-normalize to unit l2 norm; zero rows stay zero."""
    x = x.float()
    n2 = (x * x).sum(dim=-1, keepdim=True)
    return x * torch.rsqrt(n2.clamp_min(_EPS))


def mips_max_norm(x: torch.Tensor) -> float:
    """The augmentation bound M: the max row norm of the corpus."""
    if x.shape[0] == 0:
        return 0.0
    return float(torch.sqrt((x.float() ** 2).sum(dim=-1).max()))


def mips_augment(x: torch.Tensor, m: float) -> torch.Tensor:
    """Append ``sqrt(M^2 - |x|^2)`` per row (d -> d+1); rows with
    ``|x| > M`` clamp it to 0 with a RuntimeWarning."""
    x = x.float()
    n2 = (x * x).sum(dim=-1)
    slack = m * m - n2
    over = int((slack < -1e-6 * max(m * m, 1.0)).sum()) if x.shape[0] else 0
    if over:
        warnings.warn(
            f"mips: {over} row(s) exceed the augmentation bound M={m:.4g}; "
            "their augmented coordinate is clamped to 0", RuntimeWarning,
            stacklevel=3)
    aug = torch.sqrt(slack.clamp_min(0.0))
    return torch.cat([x, aug[:, None]], dim=-1)


def transform_corpus(
    x: torch.Tensor, metric: str, *, mips_m: float | None = None
) -> tuple[torch.Tensor, float]:
    """Metric reduction of corpus rows. Returns ``(x_t, mips_m)``;
    ``mips_m`` is 0.0 except under mips."""
    check_metric(metric)
    if metric == "l2":
        return x.float(), 0.0
    if metric == "cosine":
        return normalize_rows(x), 0.0
    m = mips_max_norm(x) if mips_m is None else mips_m
    return mips_augment(x, m), m


def transform_queries(q: torch.Tensor, metric: str) -> torch.Tensor:
    """Metric reduction of query rows: cosine normalizes, mips appends the
    literal 0 coordinate (d -> d+1), l2 is the identity."""
    check_metric(metric)
    q = q.float()
    if metric == "l2":
        return q
    if metric == "cosine":
        return normalize_rows(q)
    return torch.nn.functional.pad(q, (0, 1))


def similarity_from_dist(dist: torch.Tensor, metric: str, *, q2=None,
                         mips_m: float = 0.0) -> torch.Tensor:
    """Transformed-space squared l2 back to the native similarity: cosine
    ``1 - d2/2``; mips ``(|q|^2 + M^2 - d2) / 2`` (``q2`` = squared norms
    of the raw queries, broadcast against ``dist``); l2 returns ``dist``.
    Empty slots (+inf) come back -inf."""
    check_metric(metric)
    if metric == "l2":
        return dist
    if metric == "cosine":
        sim = 1.0 - dist / 2.0
    else:
        if q2 is None:
            raise ValueError("mips similarity needs q2 (raw-query "
                             "squared norms)")
        q2 = torch.as_tensor(q2, dtype=torch.float32, device=dist.device)
        if q2.dim() == dist.dim() - 1:
            q2 = q2[..., None]
        sim = (q2 + mips_m * mips_m - dist) / 2.0
    return torch.where(torch.isfinite(dist), sim, -torch.inf)


def transformed_dim(d: int, metric: str) -> int:
    """Logical feature dim after the reduction (mips appends one)."""
    check_metric(metric)
    return d + 1 if metric == "mips" else d


def filter_frac(filter_ids, n: int | None = None) -> float:
    """Fraction of rows a filter mask admits (1.0 = unfiltered), over the
    (n,) shared or (q, n) per-query layouts of ``graph_search``'s
    ``filter_ids``."""
    if filter_ids is None:
        return 1.0
    return float(torch.as_tensor(filter_ids, dtype=torch.bool)
                 .float().mean())
