"""The paper's DLRM workloads: Wide&Deep (Model-X), xDeepFM (Model-Y), DCN
(Model-Z), and DLRM-DCNv2, MLPerf Training's recommendation model.

Port of ``repro/configs/dlrm_models.py``. Criteo-like feature layout: 13
dense features + 26 categorical features, one embedding table each, batch
512 (the paper's §6 setup). ``table_offsets`` and ``embedding_plan`` use
this package's own helpers.

DLRM-DCNv2 (``kind="dcnv2"``, the port's own: the reference has no such
model) is the model of MLPerf Training's recommendation benchmark
(``mlcommons/training`` ``recommendation_v2/torchrec_dlrm``; Wang et al.,
DCN V2, arXiv 2008.13535): a bottom MLP over the dense features, whose
output joins the 26 pooled bags, a low-rank cross network and an over MLP
(``mlp_dims``). Its bags are multi-hot with a fixed size per feature:
``multi_hot`` is then a tuple, one size per table, and a batch's
``sparse`` ids are sample-major ``(B, sum(multi_hot))``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple, Union


@dataclass(frozen=True)
class DLRMConfig:
    name: str
    kind: str                           # wide_deep | xdeepfm | dcn | dcnv2
    n_dense: int = 13
    n_tables: int = 26
    # rows per embedding table (hash-bucket sizes; heavy-tailed like Criteo)
    table_rows: Tuple[int, ...] = ()
    embed_dim: int = 16                 # D in the paper's Eqn 5 / §5.3
    mlp_dims: Tuple[int, ...] = (512, 256, 128)   # dcnv2: the over arch
    cross_layers: int = 3               # DCN, DCNv2
    # DCNv2: the cross network's rank (V_l: d_in -> rank, W_l: rank -> d_in)
    cross_low_rank: int = 0
    # DCNv2: the bottom MLP over the dense features, ReLU on every layer; its
    # last width is embed_dim
    bottom_mlp_dims: Tuple[int, ...] = ()
    cin_layers: Tuple[int, ...] = (128, 128)  # xDeepFM CIN feature maps
    batch_size: int = 512
    pooling: str = "sum"                # sum | mean | max (paper §2.1)
    # lookups per table per sample: one for every table, or one per table
    multi_hot: Union[int, Tuple[int, ...]] = 4
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
        if not isinstance(self.multi_hot, int):
            sizes = tuple(int(h) for h in self.multi_hot)
            if len(sizes) != self.n_tables or min(sizes) < 1:
                raise ValueError(f"multi_hot {sizes}: one size >= 1 per "
                                 f"table of {self.n_tables}")
            object.__setattr__(self, "multi_hot", sizes)
        if self.kind == "dcnv2" and (
                not self.bottom_mlp_dims or self.cross_low_rank < 1
                or self.bottom_mlp_dims[-1] != self.embed_dim):
            raise ValueError("dcnv2: a bottom MLP ending at embed_dim and a "
                             "cross rank >= 1")

    @property
    def bag_sizes(self) -> Optional[Tuple[int, ...]]:
        """Per-table lookups of a ragged (``(B, sum)``) batch, or None for
        one ``multi_hot`` shared by every table (``(B, T, H)`` batches)."""
        return None if isinstance(self.multi_hot, int) else self.multi_hot

    @property
    def lookups_per_sample(self) -> int:
        sizes = self.bag_sizes
        return self.n_tables * int(self.multi_hot) if sizes is None \
            else sum(sizes)

    @property
    def interaction_dim(self) -> int:
        """Width of ``x0``, the dense features (DCNv2: the bottom MLP's
        output) beside the flattened bags."""
        dense = self.bottom_mlp_dims[-1] if self.kind == "dcnv2" \
            else self.n_dense
        return dense + self.n_tables * self.embed_dim

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
            layout=layout, sparse_update=sparse_update,
            bag_sizes=self.bag_sizes)

    def param_count(self) -> int:
        emb = self.total_embedding_rows * self.embed_dim
        d_in = self.interaction_dim
        dense = 0
        if self.kind == "dcnv2":
            prev = self.n_dense
            for h in self.bottom_mlp_dims:
                dense += prev * h + h
                prev = h
            dense += self.cross_layers * (
                2 * d_in * self.cross_low_rank + d_in)
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

# MLPerf Training's DLRM-DCNv2 on Criteo 1TB (mlcommons/training,
# recommendation_v2/torchrec_dlrm): the 26 vocabularies with the largest
# capped at 40 M rows, and the fixed multi-hot sizes of its synthetic
# multi-hot dataset; batch 8,192 a GPU of the 65,536 global batch
CRITEO_1TB_ROWS = (
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000, 40000000,
    40000000, 590152, 12973, 108, 36)
CRITEO_1TB_MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1,
                        1, 12, 100, 27, 10, 3, 1, 1)
DLRM_DCNV2 = DLRMConfig(
    name="dlrm_dcnv2", kind="dcnv2", table_rows=CRITEO_1TB_ROWS,
    embed_dim=128, bottom_mlp_dims=(512, 256, 128),
    mlp_dims=(1024, 1024, 512, 256), cross_layers=3, cross_low_rank=512,
    batch_size=8192, multi_hot=CRITEO_1TB_MULTI_HOT)


def reduced_dlrm(cfg: DLRMConfig) -> DLRMConfig:
    """The few-table, narrow-width version the CPU tests run. DLRM-DCNv2
    keeps ragged bags (4 tables of 3, 1, 12 and 2 lookups), a bottom MLP
    16-8, two cross layers of rank 4 and an over MLP 16-8."""
    if cfg.kind == "dcnv2":
        return dataclasses.replace(
            cfg, n_dense=4, n_tables=4, table_rows=(64, 3, 200, 40),
            embed_dim=8, bottom_mlp_dims=(16, 8), mlp_dims=(16, 8),
            cross_layers=2, cross_low_rank=4, batch_size=32,
            multi_hot=(3, 1, 12, 2))
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
