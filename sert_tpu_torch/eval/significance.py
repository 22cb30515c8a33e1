"""Paired significance tests between two runs.

The companion papers report statistical significance of metric deltas
between systems on the same topic set (the standard IR workflow the
reference's evaluation fed into). Two tests on the paired per-topic
metric values:

  * paired two-sided randomization (permutation) test — the IR-community
    default (Smucker et al., CIKM 2007: preferable to the t-test for IR
    metrics); exact over all 2^n sign flips when n <= ``exact_limit``,
    Monte Carlo otherwise (deterministic seed);
  * paired two-sided Student t-test as a cross-check (normal-approximation
    p via the t CDF computed with the regularized incomplete beta
    function — no scipy dependency).

Only topics present in BOTH runs' evaluations pair up (trec_eval
convention: systems are compared on the intersection).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np


def paired_diffs(per_topic_a: Mapping[str, Mapping[str, float]],
                 per_topic_b: Mapping[str, Mapping[str, float]],
                 measure: str) -> Tuple[np.ndarray, Sequence[str]]:
    """Per-topic metric differences (a - b) over the shared topics,
    excluding the 'all' macro row."""
    shared = sorted((set(per_topic_a) & set(per_topic_b)) - {"all"})
    diffs = np.array([per_topic_a[q][measure] - per_topic_b[q][measure]
                      for q in shared], dtype=np.float64)
    return diffs, shared


def randomization_test(diffs: np.ndarray, n_samples: int = 100_000,
                       exact_limit: int = 20, seed: int = 0) -> float:
    """Two-sided paired randomization p-value for mean(diffs) != 0.

    Under H0 each topic's sign is exchangeable; p = fraction of sign
    assignments whose |mean| >= |observed mean|. Exact enumeration for
    n <= exact_limit (2^n assignments), else Monte Carlo including the
    identity assignment (the +1 correction keeps p > 0)."""
    n = diffs.size
    if n == 0:
        return 1.0
    observed = abs(diffs.mean())
    if observed == 0.0:
        return 1.0
    if n <= exact_limit:
        signs = np.array([1.0, -1.0])
        # enumerate via bits: [2^n, n] sign matrix in chunks to bound memory
        count, total = 0, 1 << n
        step = 1 << 16
        for lo in range(0, total, step):
            idx = np.arange(lo, min(lo + step, total), dtype=np.uint64)
            bits = (idx[:, None] >> np.arange(n, dtype=np.uint64)) & 1
            means = (signs[bits.astype(int)] * diffs).mean(axis=1)
            count += int((np.abs(means) >= observed - 1e-12).sum())
        return count / total
    rng = np.random.default_rng(seed)
    flips = rng.integers(0, 2, size=(n_samples, n)) * 2 - 1
    means = (flips * diffs).mean(axis=1)
    hits = int((np.abs(means) >= observed - 1e-12).sum())
    return (hits + 1) / (n_samples + 1)


def _betainc(a: float, b: float, x: float, iters: int = 200) -> float:
    """Regularized incomplete beta I_x(a, b) via Lentz continued fraction."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    if x > (a + 1) / (a + b + 2):
        return 1.0 - _betainc(b, a, 1.0 - x, iters)
    ln_front = (a * math.log(x) + b * math.log1p(-x)
                - math.log(a) - (math.lgamma(a) + math.lgamma(b)
                                 - math.lgamma(a + b)))
    # Lentz's algorithm for the continued fraction
    tiny = 1e-300
    f, c, d = tiny, tiny, 0.0
    for i in range(iters * 2):
        m = i // 2
        if i == 0:
            num = 1.0
        elif i % 2 == 0:
            num = (m * (b - m) * x) / ((a + 2 * m - 1) * (a + 2 * m))
        else:
            num = -((a + m) * (a + b + m) * x) / ((a + 2 * m) * (a + 2 * m + 1))
        d = 1.0 + num * d
        d = 1.0 / (d if abs(d) > tiny else tiny)
        c = 1.0 + num / (c if abs(c) > tiny else tiny)
        f *= c * d
        if abs(1.0 - c * d) < 1e-12:
            break
    return math.exp(ln_front) * (f - tiny)


def paired_t_test(diffs: np.ndarray) -> float:
    """Two-sided paired t-test p-value (exact t CDF, no scipy)."""
    n = diffs.size
    if n < 2:
        return 1.0
    sd = diffs.std(ddof=1)
    if sd == 0.0:
        return 1.0 if diffs.mean() == 0.0 else 0.0
    t = diffs.mean() / (sd / math.sqrt(n))
    df = n - 1
    x = df / (df + t * t)
    return _betainc(df / 2.0, 0.5, x)


def compare_runs(per_topic_a, per_topic_b, measures: Sequence[str],
                 n_samples: int = 100_000, seed: int = 0) -> Dict[str, Dict]:
    """Per-measure comparison report: means, delta, and both p-values."""
    out: Dict[str, Dict] = {}
    for m in measures:
        diffs, shared = paired_diffs(per_topic_a, per_topic_b, m)
        mean_a = float(np.mean([per_topic_a[q][m] for q in shared])) if shared else 0.0
        mean_b = float(np.mean([per_topic_b[q][m] for q in shared])) if shared else 0.0
        out[m] = {
            "topics": len(shared),
            "mean_a": mean_a,
            "mean_b": mean_b,
            "delta": mean_a - mean_b,
            "p_randomization": randomization_test(diffs, n_samples=n_samples,
                                                  seed=seed),
            "p_ttest": paired_t_test(diffs),
        }
    return out
