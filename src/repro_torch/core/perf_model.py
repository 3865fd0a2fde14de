"""Resource–performance model (paper §4.1, Eqns 1–6) + online NNLS fitting.

Copy of ``repro/core/perf_model.py`` (numpy/scipy only): the same
features and the same NNLS fit on the same rows, so a set of observations
gives the same ``alpha`` and ``beta_sum`` in either package.

Iteration time decomposes into

    T_grad = α_grad · m/λ_w + β_grad                         (Eqn 2)
    T_upd  = α_upd  · w/(p·λ_p) + β_upd                      (Eqn 3)
    T_sync = α_sync · (M/p)/(B/w) + β_sync                   (Eqn 4)
    T_emb  = α_emb  · m·D/p + β_emb                          (Eqn 5)

    Ψ_thp  = w·m / (T_comp + T_comm)                         (Eqn 1)

All α, β ≥ 0. The four β's share a constant feature column, so only their sum
is identifiable — the paper itself reports "2.45 for the sum of β". Fitting
minimizes relative error (a first-order proxy for the paper's RMSLE) via
non-negative least squares on rows scaled by 1/T (SciPy NNLS [4]).

On the TPU mesh the same algebra holds with w ↔ data-axis size, p ↔ model-axis
size, λ ↔ chips per node, B ↔ ICI bandwidth (see DESIGN.md §2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import nnls


@dataclass(frozen=True)
class JobResources:
    """One resource allocation A (decision variables of §4.2)."""
    w: int            # number of workers
    p: int            # number of parameter servers
    cpu_w: float      # λ_w: CPU cores per worker
    cpu_p: float      # λ_p: CPU cores per PS
    mem_w: float = 8.0   # GB per worker
    mem_p: float = 16.0  # GB per PS

    def total_cpu(self) -> float:
        return self.w * self.cpu_w + self.p * self.cpu_p

    def total_mem(self) -> float:
        return self.w * self.mem_w + self.p * self.mem_p


@dataclass(frozen=True)
class JobStatics:
    """Per-job constants of the model."""
    batch_size: int      # m (fixed during training, §4.1)
    model_size: float    # M: dense-part parameter bytes (network traffic unit)
    bandwidth: float     # B: per-worker NIC / ICI bandwidth (bytes/s)
    emb_dim: float       # D: embedding dimension (Eqn 5)


FEATURES = ("grad", "upd", "sync", "emb")


def feature_vector(r: JobResources, s: JobStatics) -> np.ndarray:
    m = s.batch_size
    return np.array([
        m / max(r.cpu_w, 1e-9),                              # T_grad slope
        r.w / max(r.p * r.cpu_p, 1e-9),                      # T_upd slope
        (s.model_size / max(r.p, 1)) / (s.bandwidth / max(r.w, 1)),  # T_sync
        m * s.emb_dim / max(r.p, 1),                         # T_emb slope
        1.0,                                                  # Σβ
    ])


@dataclass
class PerfModel:
    alpha: np.ndarray = field(default_factory=lambda: np.zeros(4))
    beta_sum: float = 0.0
    fitted: bool = False

    # --------------------------------------------------------------- predict
    def t_iter(self, r: JobResources, s: JobStatics) -> float:
        x = feature_vector(r, s)
        coef = np.concatenate([self.alpha, [self.beta_sum]])
        return float(x @ coef)

    def throughput(self, r: JobResources, s: JobStatics) -> float:
        t = self.t_iter(r, s)
        if t <= 0:
            return 0.0
        return r.w * s.batch_size / t                         # Eqn 1

    def term_breakdown(self, r: JobResources, s: JobStatics) -> Dict[str, float]:
        x = feature_vector(r, s)
        return {name: float(self.alpha[i] * x[i]) for i, name in enumerate(FEATURES)} | {
            "beta": self.beta_sum}

    # ------------------------------------------------------------------- fit
    def fit(self, observations: Sequence[Tuple[JobResources, JobStatics, float]]
            ) -> "PerfModel":
        """observations: (resources, statics, measured T_iter seconds)."""
        if len(observations) < 2:
            return self
        X = np.stack([feature_vector(r, s) for r, s, _ in observations])
        t = np.array([max(ti, 1e-9) for _, _, ti in observations])
        # relative-error weighting ≈ RMSLE for small errors
        Xw = X / t[:, None]
        yw = np.ones_like(t)
        try:
            coef, _ = nnls(Xw, yw)
        except (np.linalg.LinAlgError, RuntimeError):
            # newer scipy raises LinAlgError on singular systems (e.g. all
            # observations at the same resource point); fall back to a
            # minimum-norm least-squares fit clipped to the NNLS domain
            coef, *_ = np.linalg.lstsq(Xw, yw, rcond=None)
            coef = np.clip(coef, 0.0, None)
        self.alpha = coef[:4]
        self.beta_sum = float(coef[4])
        self.fitted = True
        return self

    def rmsle(self, observations) -> float:
        errs = []
        for r, s, ti in observations:
            pred = max(self.t_iter(r, s), 1e-9)
            errs.append((np.log1p(pred) - np.log1p(max(ti, 1e-9))) ** 2)
        return float(np.sqrt(np.mean(errs))) if errs else float("nan")


def synthesize_t_iter(r: JobResources, s: JobStatics, alpha: Sequence[float],
                      beta_sum: float, noise: float = 0.0,
                      rng: Optional[np.random.Generator] = None) -> float:
    """Ground-truth generator for tests/simulator (same algebra as the model)."""
    x = feature_vector(r, s)
    t = float(x @ np.concatenate([np.asarray(alpha, float), [beta_sum]]))
    if noise and rng is not None:
        t *= float(rng.lognormal(0.0, noise))
    return max(t, 1e-6)
