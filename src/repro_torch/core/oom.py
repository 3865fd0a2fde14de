"""OOM prevention (paper §5.3): predictive embedding-memory growth model.

Copy of ``repro/core/oom.py`` (numpy only): the same fit of memory against
samples, so a run of observations gives the same prediction in either
package.

    M_emb = T · D · φ_cats,   Δφ_cats ∝ Ψ_thp · Δt

i.e. embedding memory grows linearly in *samples consumed* while new feature
categories keep arriving. The predictor regresses observed PS memory against
cumulative samples and extrapolates to job completion; if the prediction
crosses the PS memory capacity before the job finishes, it recommends a
pre-emptive vertical scale-up (paper: OOM-caused failures 4.7 % → 0.23 %).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class OOMPredictor:
    dtype_bytes: int = 4          # T
    emb_dim: int = 16             # D
    window: int = 64              # observations kept (rolling)
    safety_factor: float = 1.1    # recommend capacity with headroom
    _samples: List[float] = field(default_factory=list)
    _mem: List[float] = field(default_factory=list)

    # ------------------------------------------------------------------
    def observe(self, samples_consumed: float, mem_bytes: float) -> None:
        self._samples.append(float(samples_consumed))
        self._mem.append(float(mem_bytes))
        if len(self._samples) > self.window:
            self._samples.pop(0)
            self._mem.pop(0)

    def growth_rate(self) -> Optional[float]:
        """bytes per sample (dM/dsamples); None until ≥2 observations."""
        if len(self._samples) < 2:
            return None
        x = np.asarray(self._samples)
        y = np.asarray(self._mem)
        denom = float(((x - x.mean()) ** 2).sum())
        if denom <= 0:
            return None
        slope = float(((x - x.mean()) * (y - y.mean())).sum() / denom)
        return max(slope, 0.0)

    def categories_per_sample(self) -> Optional[float]:
        """Δφ_cats per sample implied by the growth rate."""
        g = self.growth_rate()
        if g is None:
            return None
        return g / (self.dtype_bytes * self.emb_dim)

    def predict(self, at_samples: float) -> Optional[float]:
        g = self.growth_rate()
        if g is None or not self._samples:
            return None
        return self._mem[-1] + g * max(at_samples - self._samples[-1], 0.0)

    # ------------------------------------------------------------------
    def will_oom(self, capacity_bytes: float, samples_to_completion: float
                 ) -> Tuple[bool, Optional[float]]:
        """(True, predicted_peak) if projected to exceed capacity pre-finish."""
        if not self._samples:
            return False, None
        peak = self.predict(self._samples[-1] + max(samples_to_completion, 0.0))
        if peak is None:
            return False, None
        return peak > capacity_bytes, peak

    def recommended_capacity(self, samples_to_completion: float) -> Optional[float]:
        _, peak = self.will_oom(float("inf"), samples_to_completion)
        if peak is None:
            return None
        return peak * self.safety_factor
