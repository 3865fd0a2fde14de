"""Constants shared by the kernels and their plain versions.

Copied from ``repro/kernels/common.py``:

* ``NEG_INF`` — identity of max-pooling accumulators: the most negative
  finite float32 in spirit, so ``max(NEG_INF, x) == x`` for every finite
  ``x`` a table row can hold.
* ``MASK_VALUE`` — additive mask for pre-softmax attention scores, small
  enough that ``exp(MASK_VALUE - m)`` underflows to 0 and large enough that
  masked-score arithmetic cannot overflow to -inf.
"""
from __future__ import annotations

NEG_INF = -3.0e38       # max-combiner identity (≈ most negative finite f32)
MASK_VALUE = -1e30      # attention score mask (softmax-safe)
