"""Live embedding re-planning: observed skew → re-sharded, rebuilt step.

Port of ``repro/train/replan.py``. It closes the loop around
``HotTableTracker``'s ``ReplanDecision``:

    observe (decayed rolling counts, worker-side ids)
      → trigger (imbalance over threshold, hysteresis)
        → snapshot   (FlashCheckpoint, old layout — §5.2 flash checkpoint)
        → permute    (pooled rows + optimizer moments, within-table only)
        → re-plan    (balanced vocab ranges on the ShardingPolicy,
                      measured ``table_hot`` prefixes for the hot-row cache)
        → rebuild    (``make_dlrm_train_step(plan=plan.with_replan(...))``)
        → remap      (incoming ids, off the hot path, composable)

Everything is bit-exact: a permutation moves identical row values, ids are
remapped consistently, and each bag adds the same row values in the same
order whether a row comes from the cache, the flat pool or a re-padded
pool; the dedupe of the sparse backward is stable by position, so its
per-row sums keep their order under the permutation.

The row moves (``index_select`` and the padded scatter of
``PaddedLayout.pad_rows``) run on the state's own device and always return
new tensors: the fused sparse step updates the pooled stores in place, so
the state passed in stays valid, and steppable, after any call here.
Checkpoints store the canonical flat row order (``save_with_layout``), so
every blob restores onto any layout and shard count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.dlrm_models import DLRMConfig
from repro_torch.core.flash_checkpoint import FlashCheckpoint, LeafSpec, keystr
from repro_torch.core.sharding_service import ReplanDecision
from repro_torch.kernels.fused_embedding import (column_values, lookup_tables,
                                                table_offsets)
from repro_torch.models.dlrm import POOLED_KEYS
from repro_torch.sharding.policy import (EmbeddingPlan, PaddedLayout,
                                         ShardingPolicy, make_dlrm_policy,
                                         padded_layout_for_ranges,
                                         uniform_vocab_ranges)
from repro_torch.train import state_tree
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.optim import Optimizer

# the one leaf a stamped blob may lack (blobs from before padded layouts)
PADDED_N_PS_KEY = keystr(("padded_n_ps",))


class EmbeddingRemapper:
    """Composable raw-id → current-layout remap (ingestion side of a re-plan).

    The data stream keeps emitting *raw* per-table-local ids; after each
    applied re-plan the pooled rows move, so lookups must go through the
    composed permutation. The remap is a single numpy take per batch on the
    input pipeline; it never touches the train step.
    """

    def __init__(self, table_rows, bag_sizes=None):
        self.table_rows = tuple(int(r) for r in table_rows)
        self.bag_sizes = bag_sizes      # per-table lookups of ragged batches
        self.offsets = np.asarray(table_offsets(self.table_rows), np.int64)
        self.total_rows = int(sum(self.table_rows))
        # raw global row -> current layout global row (identity before any plan)
        self.map = np.arange(self.total_rows, dtype=np.int64)
        self.n_plans = 0

    def compose(self, permutation: np.ndarray) -> None:
        """Fold one applied re-plan's flat-row permutation
        (``perm[old_row] = new_row``) into the remap."""
        self.map = np.asarray(permutation, np.int64)[self.map]
        self.n_plans += 1

    def remap(self, sparse: np.ndarray) -> np.ndarray:
        """(B, T, H) raw per-table-local ids (or ragged (B, sum(bag_sizes)))
        → current-layout local ids.

        Permutations never cross table boundaries, so the result is again a
        valid per-table-local id tensor (same dtype as the input).
        Out-of-range raw ids raise ``ValueError`` naming the table: past the
        offset shift they would index a neighbouring table's rows.
        """
        sparse = np.asarray(sparse)
        rows = column_values(self.table_rows, sparse.ndim, self.bag_sizes)
        offs = column_values(self.offsets, sparse.ndim, self.bag_sizes)
        bad = (sparse < 0) | (sparse.astype(np.int64) >= rows)
        if bad.any():
            at = tuple(int(i[0]) for i in np.nonzero(bad))
            t = at[1] if sparse.ndim == 3 else lookup_tables(
                self.bag_sizes)[at[1]]
            raise ValueError(
                f"sparse id {int(sparse[at])} out of range for table "
                f"{t} (rows={self.table_rows[t]}): raw ids must lie in "
                f"[0, {self.table_rows[t]}) — refusing to index garbage rows")
        g = sparse.astype(np.int64) + offs
        return (self.map[g] - offs).astype(sparse.dtype)

    def remap_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Copy of a criteo-style batch dict with its "sparse" ids remapped."""
        out = dict(batch)
        out["sparse"] = self.remap(batch["sparse"])
        return out


def _map_pooled_leaves(state, match, move):
    """Apply ``move`` to every pooled-row leaf of a DLRM train state: a
    tensor whose path holds a ``tables``/``wide`` key and whose shape
    ``match`` accepts (params and their optimizer moments alike). Every
    other leaf passes through untouched."""
    def visit(node, keys):
        if isinstance(node, dict):
            return {k: visit(v, keys | {k}) for k, v in node.items()}
        if torch.is_tensor(node) and (POOLED_KEYS & keys) and match(node):
            return move(node)
        return node

    return visit(state, frozenset())


def permute_train_state(state, total_rows: int, permutation: np.ndarray):
    """Move every pooled-row leaf to a new layout: ``new[perm[i]] = old[i]``
    along axis 0 of each ``(total_rows, ...)`` leaf, on its own device.
    Returns a new state; row values are moved, never changed."""
    inv = np.argsort(np.asarray(permutation))
    index = {}

    def move(leaf):
        if leaf.device not in index:
            index[leaf.device] = torch.as_tensor(inv, device=leaf.device)
        return leaf.index_select(0, index[leaf.device])

    return _map_pooled_leaves(
        state, lambda leaf: leaf.dim() >= 1 and leaf.shape[0] == total_rows,
        move)


def pad_train_state(state, total_rows: int, layout: PaddedLayout):
    """Flat-layout DLRM train state → the padded physical layout: every
    ``(total_rows, ...)`` pooled leaf becomes ``(n_ps, max_range, ...)``
    (padding slots zero). ``unpad_train_state`` inverts it bit for bit."""
    return _map_pooled_leaves(
        state, lambda leaf: leaf.dim() >= 1 and leaf.shape[0] == total_rows,
        layout.pad_rows)


def unpad_train_state(state, total_rows: int, layout: PaddedLayout):
    """Padded-layout DLRM train state → the canonical flat layout (the
    inverse of ``pad_train_state``, dropping the padding)."""
    del total_rows  # shape is implied by the layout; kept for symmetry
    return _map_pooled_leaves(
        state, lambda leaf: leaf.dim() >= 2
        and tuple(leaf.shape[:2]) == (layout.n_ps, layout.max_range),
        layout.unpad_rows)


@dataclass
class ReplanResult:
    """Everything the training loop swaps in after an applied re-plan."""
    state: Dict[str, Any]                   # permuted (and re-placed) state
    step_fn: Callable                       # rebuilt with the new plan
    policy: ShardingPolicy                  # carries the balanced vocab ranges
    decision: ReplanDecision
    layout: Optional[PaddedLayout] = None   # physical layout of `state`
    plan: Optional[EmbeddingPlan] = None    # the plan `step_fn` runs


def apply_replan(state, cfg: DLRMConfig, optimizer: Optimizer,
                 decision: ReplanDecision, *,
                 remapper: Optional[EmbeddingRemapper] = None,
                 mesh=None, opt_name: str = "adagrad",
                 grad_compress: bool = False,
                 layout: Optional[PaddedLayout] = None,
                 plan: Optional[EmbeddingPlan] = None) -> ReplanResult:
    """Execute one live re-plan on a running job's state.

    Permutes the pooled rows and their optimizer moments to the decision's
    frequency-packed layout, attaches the balanced vocab ranges to the
    policy, and rebuilds the train step under
    ``plan.with_replan(decision.table_hot, new_layout)`` (``plan`` = the
    old step's plan, default the config's), so a fused sparse-update job
    stays fused. A padded job (``layout`` given) is unpadded, permuted in
    the flat space and re-padded onto
    ``padded_layout_for_ranges(decision.vocab_ranges)``. The caller routes
    later batches through ``remapper`` (composed here) and calls
    ``tracker.mark_applied(decision)``; for crash safety it writes a
    ``save_with_layout`` snapshot of the old state first. ``state`` stays
    valid. ``mesh`` must be None and ``opt_name`` is unused: both name
    GSPMD shardings, which one GPU does not have.
    """
    del opt_name
    policy = make_dlrm_policy(mesh, vocab_ranges=decision.vocab_ranges)
    R = cfg.total_embedding_rows
    flat_state = state if layout is None else \
        unpad_train_state(state, R, layout)
    new_state = permute_train_state(flat_state, R, decision.permutation)
    new_layout = None
    if layout is not None:
        new_layout = padded_layout_for_ranges(decision.vocab_ranges)
        new_state = pad_train_state(new_state, R, new_layout)
    if remapper is not None:
        remapper.compose(decision.permutation)
    base_plan = plan if plan is not None else cfg.embedding_plan()
    new_plan = base_plan.with_replan(decision.table_hot, new_layout)
    step_fn = trainer_mod.make_dlrm_train_step(
        cfg, optimizer, grad_compress=grad_compress, plan=new_plan)
    return ReplanResult(state=new_state, step_fn=step_fn, policy=policy,
                        decision=decision, layout=new_layout, plan=new_plan)


def restore_on_plan(cfg: DLRMConfig, optimizer: Optimizer, opt_name: str,
                    ckpt: FlashCheckpoint, decision: ReplanDecision, *,
                    device, mesh=None, step: Optional[int] = None,
                    grad_compress: bool = False, padded: bool = False,
                    plan: Optional[EmbeddingPlan] = None
                    ) -> Tuple[Dict[str, Any], int, Callable, ShardingPolicy,
                               EmbeddingRemapper]:
    """Restore an OLD-plan ``save_with_layout`` checkpoint onto a NEW plan,
    on ``device``.

    The restored state is permuted through the decision (bit-exact), padded
    onto ``padded_layout_for_ranges(decision.vocab_ranges)`` when
    ``padded`` or when the blob was stamped padded, and the step is rebuilt
    under ``plan.with_replan(decision.table_hot, new layout)``. Returns
    ``(state, restored_step, step_fn, policy, remapper)``, the remapper
    already composed with the decision.
    """
    del opt_name
    policy = make_dlrm_policy(mesh, vocab_ranges=decision.vocab_ranges)
    R = cfg.total_embedding_rows
    state, restored_step, remapper, _old_hot, _old_ranges, old_layout = \
        restore_with_layout(cfg, optimizer, ckpt, step=step, device=device)
    if old_layout is not None:      # stamped padded: back to flat to permute
        state = unpad_train_state(state, R, old_layout)
    state = permute_train_state(state, R, decision.permutation)
    new_layout = None
    if padded or old_layout is not None:
        new_layout = padded_layout_for_ranges(decision.vocab_ranges)
        state = pad_train_state(state, R, new_layout)
    remapper.compose(decision.permutation)
    base_plan = plan if plan is not None else cfg.embedding_plan()
    new_plan = base_plan.with_replan(decision.table_hot, new_layout)
    step_fn = trainer_mod.make_dlrm_train_step(
        cfg, optimizer, grad_compress=grad_compress, plan=new_plan)
    return state, restored_step, step_fn, policy, remapper


# --------------------------------------------------------- layout-stamped ckpt
def save_with_layout(ckpt: FlashCheckpoint, state, step: int,
                     remapper: EmbeddingRemapper,
                     table_hot: Optional[Tuple[int, ...]] = None,
                     vocab_ranges: Optional[Sequence[Tuple[int, int]]] = None,
                     layout: Optional[PaddedLayout] = None) -> None:
    """Checkpoint the state together with its row-layout provenance.

    The blob holds ``{"state", "layout", "table_hot", "vocab_ranges",
    "padded_n_ps"}``: the train state in the canonical flat row order
    (unpadded first when ``layout`` is given), the remapper's composed
    raw-id → layout map (int64), the cache plan (int64, all -1 for the
    config default), the applied PS ranges (int64, flattened; empty for
    uniform striping) and the padded shard count (int64 0-d, 0 for flat).
    A fresh process restores it with ``restore_with_layout``.
    """
    hot = (np.full(len(remapper.table_rows), -1, np.int64)
           if table_hot is None else np.asarray(table_hot, np.int64))
    ranges = (np.zeros((0,), np.int64) if vocab_ranges is None
              else np.asarray(vocab_ranges, np.int64).reshape(-1))
    if layout is not None:
        state = unpad_train_state(state, remapper.total_rows, layout)
    ckpt.save({"state": state_tree.to_tree(state),
               "layout": np.asarray(remapper.map, np.int64),
               "table_hot": hot, "vocab_ranges": ranges,
               "padded_n_ps": np.asarray(
                   0 if layout is None else layout.n_ps, np.int64)}, step)


def restore_with_layout(cfg: DLRMConfig, optimizer: Optimizer,
                        ckpt: FlashCheckpoint, *, device,
                        step: Optional[int] = None
                        ) -> Tuple[Dict[str, Any], int, EmbeddingRemapper,
                                   Optional[Tuple[int, ...]],
                                   Optional[Tuple[Tuple[int, int], ...]],
                                   Optional[PaddedLayout]]:
    """Restore a ``save_with_layout`` checkpoint in a fresh process, onto
    ``device``.

    Returns ``(state, restored_step, remapper, table_hot, vocab_ranges,
    layout)``: the remapper rebuilt from the stamped map, the cache plan to
    build the step with (None = config default), the applied placement plan
    to seed a fresh ``HotTableTracker`` with (None = uniform), and the
    stamped padded layout — when not None the state is already padded onto
    it (from the stamped ranges, or uniform striping when no plan was
    applied). Blobs without the ``padded_n_ps`` stamp restore flat.
    """
    like = {
        "state": state_tree.like_tree(cfg, optimizer),
        "layout": LeafSpec((cfg.total_embedding_rows,), np.int64),
        "table_hot": LeafSpec((cfg.n_tables,), np.int64),
        # placeholder shape: restore takes leaf shapes from the stored blob
        "vocab_ranges": LeafSpec((0,), np.int64),
        "padded_n_ps": LeafSpec((), np.int64),
    }
    blob, restored_step = ckpt.restore(like, step,
                                       optional_leaves=(PADDED_N_PS_KEY,))
    remapper = EmbeddingRemapper(cfg.table_rows, cfg.bag_sizes)
    remapper.map = np.array(blob["layout"], np.int64)
    hot = np.asarray(blob["table_hot"])
    table_hot = None if (hot < 0).any() else tuple(int(k) for k in hot)
    flat_ranges = np.asarray(blob["vocab_ranges"]).reshape(-1, 2)
    vocab_ranges = (None if flat_ranges.size == 0 else
                    tuple((int(s), int(e)) for s, e in flat_ranges))
    state = state_tree.from_tree(blob["state"], device)
    n_ps = int(np.asarray(blob["padded_n_ps"]))
    layout = None
    if n_ps > 0:
        layout = padded_layout_for_ranges(
            vocab_ranges if vocab_ranges is not None
            else uniform_vocab_ranges(cfg.total_embedding_rows, n_ps))
        state = pad_train_state(state, cfg.total_embedding_rows, layout)
    return state, restored_step, remapper, table_hot, vocab_ranges, layout
