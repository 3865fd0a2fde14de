"""Elastic resume: an LM job onto a device, a DLRM job onto another row
plan, layout or shard count.

Port of ``repro/train/elastic.py``. Checkpoints hold host arrays in the
reference's schema (``train/state_tree.py``). ``resume_on_mesh`` restores
an LM train state; a DLRM job checkpointed with ``n_ps`` physically-unequal
PS shards resumes onto a different shard count (or back to the flat pool)
bit-exactly, optionally through a ``ReplanDecision``'s permutation. One GPU
has no device mesh: ``mesh`` must be None, and the reference's GSPMD pieces
(``state_shardings``, ``dlrm_state_shardings``) have no counterpart.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.dlrm_models import DLRMConfig
from repro_torch.core.flash_checkpoint import FlashCheckpoint
from repro_torch.models.registry import ModelAPI
from repro_torch.sharding.policy import (NULL_POLICY, ShardingPolicy,
                                         make_dlrm_policy,
                                         padded_layout_for_ranges,
                                         uniform_vocab_ranges)
from repro_torch.train import replan as replan_mod
from repro_torch.train import state_tree
from repro_torch.train.optim import Optimizer


def resume_on_mesh(api: ModelAPI, optimizer: Optimizer, opt_name: str,
                   ckpt: FlashCheckpoint, mesh, shape: ShapeConfig, *,
                   device, step: Optional[int] = None
                   ) -> Tuple[Dict[str, Any], int, ShardingPolicy]:
    """Restore the newest (or ``step``'s) LM checkpoint onto ``device``:
    ``(state, restored_step, policy)``, the policy being the reference's
    for no mesh (it places nothing). ``mesh`` must be None."""
    del opt_name, shape
    if mesh is not None:
        raise ValueError("resume_on_mesh: device meshes are GSPMD-only; the "
                         "port places nothing by a mesh (mesh=None)")
    tree, restored_step = ckpt.restore(
        state_tree.lm_like_tree(api, optimizer), step)
    return (state_tree.lm_from_tree(tree, api.cfg, device), restored_step,
            NULL_POLICY)


def save_for_elasticity(ckpt: FlashCheckpoint, state, step: int) -> None:
    """Checkpoint a train state as it lies (flat or padded): the plain blob
    ``resume_dlrm_on_mesh`` restores."""
    ckpt.save(state_tree.to_tree(state), step)


def resume_dlrm_on_mesh(cfg: DLRMConfig, optimizer: Optimizer, opt_name: str,
                        ckpt: FlashCheckpoint, mesh, *, device,
                        decision=None, step: Optional[int] = None,
                        from_layout=None, layout=None
                        ) -> Tuple[Dict[str, Any], int, ShardingPolicy]:
    """Restore a plain DLRM checkpoint onto ``device`` and, optionally, a
    new row plan and layout.

    ``from_layout`` is the ``PaddedLayout`` the blob was saved on (None =
    flat), ``layout`` the one to resume onto (None = flat); the rows are
    re-based through the canonical flat space, with ``decision``'s
    permutation (bit-exact) in between when one is given. Returns
    ``(state, restored_step, policy)``; the caller builds its step with
    ``decision.table_hot`` and ``layout``. ``mesh`` must be None.
    """
    del opt_name
    ranges = None if decision is None else decision.vocab_ranges
    policy = make_dlrm_policy(mesh, vocab_ranges=ranges)
    R = cfg.total_embedding_rows
    like = state_tree.like_tree(cfg, optimizer, layout=from_layout)
    tree, restored_step = ckpt.restore(like, step)
    state = state_tree.from_tree(tree, device)
    if from_layout is not None:
        state = replan_mod.unpad_train_state(state, R, from_layout)
    if decision is not None:
        state = replan_mod.permute_train_state(state, R, decision.permutation)
    if layout is not None:
        state = replan_mod.pad_train_state(state, R, layout)
    return state, restored_step, policy


def resume_dlrm_stamped(cfg: DLRMConfig, optimizer: Optimizer,
                        ckpt: FlashCheckpoint, *, device,
                        onto_n_ps: Optional[int] = None, mesh=None,
                        opt_name: str = "adagrad", step: Optional[int] = None):
    """Elastic re-resume of a layout-stamped blob, e.g. after a PS loss.

    The blob's ``padded_n_ps`` stamp is the layout it was saved on;
    ``onto_n_ps`` (the surviving shard count) is the one to resume onto,
    with the uniform plan over the survivors (the live re-planning loop
    re-balances it at its next trigger). None keeps the stamped layout;
    flat jobs have no shards and ignore it. Returns ``(state,
    restored_step, remapper, table_hot, vocab_ranges, layout)`` like
    ``replan.restore_with_layout``. ``mesh`` must be None.
    """
    del opt_name
    make_dlrm_policy(mesh)          # raises for a mesh: GSPMD-only
    R = cfg.total_embedding_rows
    state, restored_step, remapper, table_hot, vocab_ranges, layout = \
        replan_mod.restore_with_layout(cfg, optimizer, ckpt, step=step,
                                       device=device)
    if onto_n_ps is not None and layout is not None and \
            onto_n_ps != layout.n_ps:
        state = replan_mod.unpad_train_state(state, R, layout)
        ranges = uniform_vocab_ranges(R, onto_n_ps)
        layout = padded_layout_for_ranges(ranges)
        state = replan_mod.pad_train_state(state, R, layout)
        vocab_ranges = tuple((int(s), int(e)) for s, e in ranges)
    return state, restored_step, remapper, table_hot, vocab_ranges, layout
