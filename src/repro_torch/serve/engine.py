"""Batched serving engine: slot-based continuous batching.

Port of ``repro/serve/engine.py`` with the same slot logic. Requests enter a
queue; the engine keeps ``slots`` decode slots, each with its own cache of
batch 1 in float32 (as the reference holds them). Each step decodes one
token for every active slot, retires finished sequences (EOS or max
tokens) and refills free slots from the queue by prefilling the prompt into
a fresh cache with the sequential ``prefill_into_cache``. Decoding is greedy
(``argmax`` over the padded vocab).

The engine runs on the device of the params: on the card every decode step
goes through K5, once per attention layer.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.registry import ModelAPI
from repro_torch.models.transformer import prefill_into_cache


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None


@dataclass
class Completion:
    rid: int
    tokens: List[int] = field(default_factory=list)


class ServeEngine:
    def __init__(self, api: ModelAPI, params, *, slots: int = 4,
                 max_len: int = 256):
        self.api = api
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = params["embed"].device
        self.queue: collections.deque[Request] = collections.deque()
        self.active: List[Optional[Request]] = [None] * slots
        self.budget: List[int] = [0] * slots
        self.outputs: Dict[int, Completion] = {}
        self.caches = [self._new_cache() for _ in range(slots)]
        self.next_token = [0] * slots
        self.steps = 0

    def _new_cache(self):
        return self.api.init_cache(1, self.max_len, torch.float32,
                                   self.device)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _prefill_slot(self, slot: int, req: Request) -> None:
        cache = self._new_cache()
        toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32,
                               device=self.device)[None, :]
        cache, logits = prefill_into_cache(self.params, cache, toks,
                                           self.api.cfg)
        self.caches[slot] = cache
        self.active[slot] = req
        self.budget[slot] = req.max_new_tokens
        self.outputs[req.rid] = Completion(req.rid)
        self.next_token[slot] = int(torch.argmax(logits[0, -1]))

    def _refill(self) -> None:
        for slot in range(self.slots):
            if self.active[slot] is None and self.queue:
                self._prefill_slot(slot, self.queue.popleft())

    def step(self) -> int:
        """One decode step across all active slots; returns #active."""
        self._refill()
        n_active = 0
        for slot in range(self.slots):
            req = self.active[slot]
            if req is None:
                continue
            n_active += 1
            tok = torch.full((1, 1), self.next_token[slot], dtype=torch.int32,
                             device=self.device)
            logits, self.caches[slot] = self.api.decode_step(
                self.params, self.caches[slot], tok)
            out = self.outputs[req.rid]
            out.tokens.append(self.next_token[slot])
            nxt = int(torch.argmax(logits[0, -1]))
            self.next_token[slot] = nxt
            self.budget[slot] -= 1
            done = self.budget[slot] <= 0 or (req.eos_id is not None
                                              and nxt == req.eos_id)
            if done:
                self.active[slot] = None
        self.steps += 1
        return n_active

    def run(self) -> Dict[int, Completion]:
        while self.queue or any(a is not None for a in self.active):
            self.step()
        return self.outputs
