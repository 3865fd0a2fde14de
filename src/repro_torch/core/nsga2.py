"""NSGA-II multi-objective evolutionary optimizer (paper §4.3 uses pymoo's [3]).

Copy of ``repro/core/nsga2.py`` (numpy only): the same draws from the
``np.random.Generator`` in the same order (tournament, SBX, mutation), so a
seed gives the same front in either package.

Self-contained implementation: fast non-dominated sorting, crowding distance,
binary tournament selection, SBX crossover + polynomial mutation, with
integer rounding for discrete resource variables. Minimizes all objectives.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Individual:
    x: np.ndarray
    f: np.ndarray
    rank: int = 0
    crowding: float = 0.0


def _dominates(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.all(a <= b) and np.any(a < b))


def fast_non_dominated_sort(pop: List[Individual]) -> List[List[Individual]]:
    fronts: List[List[Individual]] = [[]]
    S = {id(p): [] for p in pop}
    n = {id(p): 0 for p in pop}
    for p in pop:
        for q in pop:
            if p is q:
                continue
            if _dominates(p.f, q.f):
                S[id(p)].append(q)
            elif _dominates(q.f, p.f):
                n[id(p)] += 1
        if n[id(p)] == 0:
            p.rank = 0
            fronts[0].append(p)
    i = 0
    while fronts[i]:
        nxt: List[Individual] = []
        for p in fronts[i]:
            for q in S[id(p)]:
                n[id(q)] -= 1
                if n[id(q)] == 0:
                    q.rank = i + 1
                    nxt.append(q)
        i += 1
        fronts.append(nxt)
    return fronts[:-1]


def crowding_distance(front: List[Individual]) -> None:
    if not front:
        return
    n_obj = len(front[0].f)
    for p in front:
        p.crowding = 0.0
    for m in range(n_obj):
        front.sort(key=lambda p: p.f[m])
        front[0].crowding = front[-1].crowding = float("inf")
        lo, hi = front[0].f[m], front[-1].f[m]
        if hi - lo < 1e-12:
            continue
        for i in range(1, len(front) - 1):
            front[i].crowding += (front[i + 1].f[m] - front[i - 1].f[m]) / (hi - lo)


def _tournament(pop: List[Individual], rng) -> Individual:
    if len(pop) == 1:                      # degenerate population
        return pop[0]
    a, b = rng.choice(len(pop), 2, replace=False)
    pa, pb = pop[a], pop[b]
    if pa.rank != pb.rank:
        return pa if pa.rank < pb.rank else pb
    return pa if pa.crowding > pb.crowding else pb


def _sbx(x1, x2, lo, hi, rng, eta: float = 15.0):
    u = rng.random(len(x1))
    beta = np.where(u <= 0.5, (2 * u) ** (1 / (eta + 1)),
                    (1 / (2 * (1 - u))) ** (1 / (eta + 1)))
    c1 = 0.5 * ((1 + beta) * x1 + (1 - beta) * x2)
    c2 = 0.5 * ((1 - beta) * x1 + (1 + beta) * x2)
    return np.clip(c1, lo, hi), np.clip(c2, lo, hi)


def _poly_mutate(x, lo, hi, rng, eta: float = 20.0, pm: Optional[float] = None):
    pm = pm if pm is not None else 1.0 / len(x)
    y = x.copy()
    for i in range(len(x)):
        if rng.random() < pm:
            u = rng.random()
            delta = ((2 * u) ** (1 / (eta + 1)) - 1 if u < 0.5
                     else 1 - (2 * (1 - u)) ** (1 / (eta + 1)))
            y[i] = np.clip(y[i] + delta * (hi[i] - lo[i]), lo[i], hi[i])
    return y


def nsga2(objectives: Callable[[np.ndarray], Sequence[float]],
          bounds: Sequence[Tuple[float, float]], *,
          pop_size: int = 40, generations: int = 30,
          integer: bool = True, seed: int = 0,
          init: Optional[Sequence[np.ndarray]] = None
          ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Minimize ``objectives`` over box bounds; returns the Pareto front."""
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in bounds], float)
    hi = np.array([b[1] for b in bounds], float)

    def make(x) -> Individual:
        x = np.clip(np.round(x) if integer else x, lo, hi)
        f = np.asarray(objectives(x), float)
        if not np.all(np.isfinite(f)):
            raise ValueError(
                f"objectives returned non-finite values {f.tolist()} at "
                f"x={x.tolist()}; NSGA-II dominance is undefined for NaN/inf "
                "— clamp or penalize inside the objective function instead")
        return Individual(x=x, f=f)

    pop = [make(lo + rng.random(len(bounds)) * (hi - lo)) for _ in range(pop_size)]
    for i, x0 in enumerate(init or []):
        if i < len(pop):
            pop[i] = make(np.asarray(x0, float))

    for front in fast_non_dominated_sort(pop):
        crowding_distance(front)

    for _ in range(generations):
        children: List[Individual] = []
        while len(children) < pop_size:
            p1, p2 = _tournament(pop, rng), _tournament(pop, rng)
            c1, c2 = _sbx(p1.x, p2.x, lo, hi, rng)
            children.append(make(_poly_mutate(c1, lo, hi, rng)))
            if len(children) < pop_size:
                children.append(make(_poly_mutate(c2, lo, hi, rng)))
        union = pop + children
        fronts = fast_non_dominated_sort(union)
        new_pop: List[Individual] = []
        for front in fronts:
            crowding_distance(front)
            if len(new_pop) + len(front) <= pop_size:
                new_pop.extend(front)
            else:
                front.sort(key=lambda p: -p.crowding)
                new_pop.extend(front[: pop_size - len(new_pop)])
                break
        pop = new_pop

    pareto = fast_non_dominated_sort(pop)[0]
    seen = set()
    out = []
    for p in pareto:
        key = tuple(p.x.tolist())
        if key not in seen:
            seen.add(key)
            out.append((p.x, p.f))
    return out
