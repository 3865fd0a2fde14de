"""The paper's DLRM workloads: Wide&Deep (Model-X), xDeepFM (Model-Y), DCN (Model-Z).

Port of ``repro/configs/dlrm_models.py``. Criteo-like feature layout: 13
dense features + 26 categorical features, one embedding table each, batch
512 (the paper's §6 setup). ``table_offsets`` and ``embedding_plan`` use
this package's own helpers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class DLRMConfig:
    name: str
    kind: str                           # wide_deep | xdeepfm | dcn
    n_dense: int = 13
    n_tables: int = 26
    # rows per embedding table (hash-bucket sizes; heavy-tailed like Criteo)
    table_rows: Tuple[int, ...] = ()
    embed_dim: int = 16                 # D in the paper's Eqn 5 / §5.3
    mlp_dims: Tuple[int, ...] = (512, 256, 128)
    cross_layers: int = 3               # DCN
    cin_layers: Tuple[int, ...] = (128, 128)  # xDeepFM CIN feature maps
    batch_size: int = 512
    pooling: str = "sum"                # sum | mean | max (paper §2.1)
    multi_hot: int = 4                  # lookups per table per sample
    # power-law skew of the synthetic sparse-feature stream (0 = uniform)
    zipf_alpha: float = 0.0
    # hot-row cache budget in pooled rows (0 disables); split by `table_hot`
    hot_rows_k: int = 0

    def __post_init__(self):
        if not self.table_rows:
            # heavy-tailed bucket sizes, deterministic
            rows = tuple(
                int(10 ** (3 + 3 * ((i * 2654435761) % 100) / 100.0))
                for i in range(self.n_tables)
            )
            object.__setattr__(self, "table_rows", rows)

    @property
    def total_embedding_rows(self) -> int:
        return sum(self.table_rows)

    @property
    def table_offsets(self) -> Tuple[int, ...]:
        """Exclusive per-table row offsets into the pooled (R, D) table."""
        from repro_torch.kernels.fused_embedding import table_offsets
        return table_offsets(self.table_rows)

    @property
    def table_hot(self) -> Optional[Tuple[int, ...]]:
        """Default per-table hot-prefix sizes for the fused engine's cache.

        Splits ``hot_rows_k`` evenly across tables (clipped to each table's
        rows, remainder to the leading tables); the total never exceeds the
        budget.
        """
        if self.hot_rows_k <= 0:
            return None
        per, rem = divmod(self.hot_rows_k, self.n_tables)
        return tuple(min(int(r), per + (1 if t < rem else 0))
                     for t, r in enumerate(self.table_rows))

    def embedding_plan(self, *, table_hot=None, layout=None,
                       sparse_update: bool = False):
        """The ``EmbeddingPlan`` this workload's fused embedding calls run
        under; ``table_hot=None`` defaults to ``cfg.table_hot``."""
        from repro_torch.sharding.policy import EmbeddingPlan
        return EmbeddingPlan(
            offsets=self.table_offsets, combiner=self.pooling,
            table_hot=self.table_hot if table_hot is None else
            tuple(int(k) for k in table_hot),
            layout=layout, sparse_update=sparse_update)

    def param_count(self) -> int:
        emb = self.total_embedding_rows * self.embed_dim
        d_in = self.n_dense + self.n_tables * self.embed_dim
        dense = 0
        prev = d_in
        for h in self.mlp_dims:
            dense += prev * h + h
            prev = h
        dense += prev * 1 + 1
        if self.kind == "dcn":
            dense += self.cross_layers * (2 * d_in + 1)
        if self.kind == "xdeepfm":
            prev_maps = self.n_tables
            for maps in self.cin_layers:
                dense += prev_maps * self.n_tables * maps
                prev_maps = maps
            dense += sum(self.cin_layers)
        if self.kind == "wide_deep":
            dense += self.total_embedding_rows  # wide (linear) part, 1-dim
        return emb + dense


WIDE_DEEP = DLRMConfig(name="wide_deep", kind="wide_deep")
XDEEPFM = DLRMConfig(name="xdeepfm", kind="xdeepfm")
DCN = DLRMConfig(name="dcn", kind="dcn")


def reduced_dlrm(cfg: DLRMConfig) -> DLRMConfig:
    """The few-table, narrow-width version the CPU tests run."""
    return dataclasses.replace(
        cfg,
        n_dense=4,
        n_tables=6,
        table_rows=tuple([64] * 6),
        embed_dim=8,
        mlp_dims=(32, 16),
        cross_layers=2,
        cin_layers=(8, 8),
        batch_size=32,
        multi_hot=2,
    )
