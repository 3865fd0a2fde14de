"""Pre-scaling stage: warm-starting (paper §4.3, Algorithm 1).

Copy of ``repro/core/warm_start.py`` (no numpy of its own): the same
similarity and smoothing, so a config DB gives the same plan in either
package.

Given a new job's metadata, find the top-k most similar historical jobs in
the config DB and exponentially smooth their final resource configurations,
ordered from least to most similar so the most similar job dominates:

    Ā⁰ = A⁰;   Āⁱ = μ·Aⁱ + (1-μ)·Āⁱ⁻¹;   return Ā^{k-1}      (Eqn 10)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.perf_model import JobResources


@dataclass(frozen=True)
class JobMeta:
    """Features used for similarity (model metadata, §4.3)."""
    model_kind: str           # e.g. "wide_deep" / "dcn" / "xdeepfm"
    dense_params: float       # dense-part parameter count
    emb_rows: float           # total embedding rows
    emb_dim: int
    batch_size: int
    dataset_samples: float
    user: str = ""


@dataclass
class ConfigRecord:
    meta: JobMeta
    final_config: JobResources
    throughput: float = 0.0
    completed: bool = True


class ConfigDB:
    """Historical job traces (the cluster brain's config DB, §3)."""

    def __init__(self) -> None:
        self.records: List[ConfigRecord] = []

    def add(self, record: ConfigRecord) -> None:
        self.records.append(record)

    def __len__(self) -> int:
        return len(self.records)


_NUMERIC = ("dense_params", "emb_rows", "emb_dim", "batch_size", "dataset_samples")


def similarity(a: JobMeta, b: JobMeta) -> float:
    """Log-scale numeric proximity + categorical agreement, in [0, 1]."""
    score = 0.0
    for name in _NUMERIC:
        va, vb = getattr(a, name), getattr(b, name)
        la, lb = math.log1p(max(va, 0.0)), math.log1p(max(vb, 0.0))
        score += 1.0 - min(abs(la - lb) / max(la, lb, 1e-9), 1.0)
    score /= len(_NUMERIC)
    cat = (0.5 * (a.model_kind == b.model_kind) + 0.5 * (a.user == b.user))
    return 0.7 * score + 0.3 * cat


def _blend(a: JobResources, b: JobResources, mu: float) -> JobResources:
    """μ·a + (1-μ)·b elementwise (the exponential smoothing step ℰ)."""
    mix = lambda x, y: mu * x + (1 - mu) * y
    return JobResources(
        w=max(1, round(mix(a.w, b.w))),
        p=max(1, round(mix(a.p, b.p))),
        cpu_w=mix(a.cpu_w, b.cpu_w),
        cpu_p=mix(a.cpu_p, b.cpu_p),
        mem_w=mix(a.mem_w, b.mem_w),
        mem_p=mix(a.mem_p, b.mem_p),
    )


def warm_start(job: JobMeta, db: ConfigDB, *, k: int = 5, mu: float = 0.5,
               default: Optional[JobResources] = None) -> JobResources:
    """Algorithm 1. Falls back to ``default`` (cold start) on an empty DB."""
    default = default or JobResources(w=2, p=1, cpu_w=4, cpu_p=4)
    if not db.records:
        return default
    scored = sorted(
        ((similarity(job, rec.meta), i, rec) for i, rec in enumerate(db.records)
         if rec.completed),
        key=lambda t: (t[0], -t[1]))
    top = scored[-k:]                       # ascending similarity: A⁰ … A^{k-1}
    if not top:
        return default
    smoothed = top[0][2].final_config       # Ā⁰ = A⁰ (least similar of top-k)
    for _, _, rec in top[1:]:
        smoothed = _blend(rec.final_config, smoothed, mu)   # Āⁱ = μAⁱ+(1-μ)Āⁱ⁻¹
    return smoothed


def warm_start_accuracy(initial: JobResources, final: JobResources) -> float:
    """Paper Fig 9 metric: how close the initial allocation is to the final."""
    pairs = [(initial.w, final.w), (initial.p, final.p),
             (initial.cpu_w, final.cpu_w), (initial.cpu_p, final.cpu_p)]
    accs = [1.0 - abs(a - b) / max(a, b, 1e-9) for a, b in pairs]
    return sum(accs) / len(accs)
