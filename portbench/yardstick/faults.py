"""Faults planted under the timed path, to show that ``correct`` catches
them. The benchmark's own runs never plant one: ``calibrate.py`` reads
their numbers on the card and the tests drive whole runs with them.

Each fault wraps a train step ``step(state, batch) -> (state, metrics)``:

- ``unchanged``: the step computes its loss but returns its state as it
  was (it runs on a copy, since the fused step updates the stores in
  place);
- ``half_batch``: the step sees only the first half of each batch, so its
  loss and gradient are means over that half;
- ``flipped``: every parameter moves by the step's update with its sign
  turned (``p0 - (p1 - p0)``); the accumulators are the step's;
- ``shifted_rows``: the row update of each pooled store (``tables``,
  ``wide``) and of its accumulator lands one row down, as a row update
  written to the wrong rows would.

The last two leave the first loss and the gradient read from the
accumulator as they were, and each step's own norm of change: only the
later steps, which read the rows that the update wrote, see them, their
losses most.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.clone()
    return tree


def unchanged(step: Callable) -> Callable:
    def broken(state, batch):
        _, metrics = step(_clone(state), batch)
        return state, metrics
    return broken


def half_batch(step: Callable) -> Callable:
    def broken(state, batch):
        half = batch["label"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()})
    return broken


def flipped(step: Callable) -> Callable:
    def broken(state, batch):
        before = {k: v.detach().clone() for k, v in state["params"].items()}
        state, metrics = step(state, batch)
        with torch.no_grad():
            for k, v in state["params"].items():
                v.copy_(2 * before[k] - v)
        return state, metrics
    return broken


STORES = ("tables", "wide")


def shifted_rows(step: Callable) -> Callable:
    def broken(state, batch):
        trees = (state["params"], state["opt"]["acc"])
        before = [{k: t[k].detach().clone() for k in STORES if k in t}
                  for t in trees]
        state, metrics = step(state, batch)
        with torch.no_grad():
            for t, old in zip((state["params"], state["opt"]["acc"]),
                              before):
                for k, v in old.items():
                    t[k].copy_(v + torch.roll(t[k] - v, 1, 0))
        return state, metrics
    return broken


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "flipped": flipped, "shifted_rows": shifted_rows}


@contextlib.contextmanager
def planted(driver, name: str) -> Iterator[None]:
    """Within the block, ``driver.program_step`` builds steps broken by the
    fault ``name``."""
    wrap = FAULTS[name]
    original = driver.program_step

    def broken_step(*args, **kw):
        return wrap(original(*args, **kw))

    driver.program_step = broken_step
    try:
        yield
    finally:
        driver.program_step = original
