"""Flash-checkpoint (paper §5.2): in-memory checkpoints + async persistence.

Port of ``repro/core/flash_checkpoint.py``, with its on-disk schema: a step
is a ``ckpt_<step:012d>`` directory holding ``leaves.npz`` and
``MANIFEST.json`` (format 1, per-leaf CRC32, shape and dtype), and a leaf's
key is the ``jax.tree_util.keystr`` string of its path, written here
literally (``['state']['params']['tables']``). A blob written by either
package restores in the other.

The migration-critical path stores checkpoints in host memory (the paper's
distributed caching service) and flushes them to persistent storage (the
paper's RDS) on a background thread. Restore prefers the memory tier.
Checkpoints are host numpy arrays keyed by path, so restore can place them
on any device and any row layout.

``save`` copies every leaf to the host before it returns: the fused sparse
step updates the pooled stores and their moments in place, so a snapshot
that shared storage with the live tensors (``Tensor.numpy()`` of a CPU
tensor, or a kept reference to a CUDA tensor) would change under the next
step. ``restore`` returns host numpy arrays; the caller copies them onto
its device.

The disk tier is hardened against the §2.2 failure modes a restart must
survive:

* **atomic persistence** — each step writes into a ``*.tmp-<pid>`` staging
  directory and lands via one ``os.replace``; a mid-save kill leaves only a
  staging dir that eviction skips (and logs), never a half-written blob
  under a valid name;
* **per-leaf checksums** — every leaf's CRC32 is recorded in the step's
  ``MANIFEST.json`` and verified on restore, so bit-rot or a torn write
  raises ``CheckpointCorruptError`` instead of silently loading garbage;
* **newest-valid fallback** — when no explicit step is requested, restore
  walks candidates newest-first and transparently falls back past corrupt
  or unreadable blobs (recorded in ``self.events``), so recovery never
  needs manual intervention.

Legacy single-file ``ckpt_NNN.npz`` blobs (the pre-hardening format) still
restore — without checksum verification, since they carry none.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("repro_torch.flash_checkpoint")

_DATA_FILE = "leaves.npz"
_MANIFEST_FILE = "MANIFEST.json"
_FORMAT = 1


class CheckpointCorruptError(RuntimeError):
    """A persisted blob failed checksum/structure verification."""


@dataclass(frozen=True)
class LeafSpec:
    """Shape and dtype of one leaf of a restore template (the counterpart
    of ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: Any


def keystr(path: Tuple[Any, ...]) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and sequence
    indices: ``('state', 'step')`` -> ``"['state']['step']"``."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]"
                   for k in path)


def _leaves_with_path(tree, path=()) -> Iterator[Tuple[Tuple[Any, ...], Any]]:
    """(path, leaf) pairs in the reference's flatten order: dict keys
    sorted, sequences in order; anything else is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    else:
        yield path, tree


# A bfloat16 leaf lies on the host and on disk as its raw bits in a 2-byte
# void array: numpy has no bfloat16, and that is what the reference's
# ``np.savez`` writes (and ``np.load`` gives back) for its ml_dtypes
# bfloat16 arrays. The manifest names it "bfloat16", as the reference's does.
BF16_HOST = np.dtype("V2")


def _host_copy(leaf) -> np.ndarray:
    """A host numpy array that shares no storage with ``leaf``."""
    if torch.is_tensor(leaf):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(BF16_HOST)
        return host.numpy()
    return np.array(leaf, copy=True)


def host_dtype(dtype) -> np.dtype:
    """The numpy dtype a leaf of torch or numpy ``dtype`` has on the host."""
    if dtype == torch.bfloat16:
        return BF16_HOST
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_HOST else str(arr.dtype)


def _flatten(state) -> Dict[str, np.ndarray]:
    return {keystr(path): _host_copy(leaf)
            for path, leaf in _leaves_with_path(state)}


def _rebuild(like, fill, path=()):
    if isinstance(like, dict):
        return {k: _rebuild(v, fill, path + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, fill, path + (i,))
                          for i, v in enumerate(like))
    return fill(path, like)


def _unflatten(like, flat: Dict[str, np.ndarray], *,
               optional_leaves: Tuple[str, ...] = ()):
    """Rebuild ``like``'s tree from flat path-keyed arrays.

    A leaf absent from ``flat`` raises — restoring a truncated or
    wrong-schema blob must never silently zero state — UNLESS its keystr is
    named in ``optional_leaves``, in which case it is filled with zeros of
    the ``like`` leaf's shape/dtype. That is how newer blob schemas (e.g.
    the layout stamp's ``padded_n_ps`` field) restore older checkpoints
    that predate the field, without loosening the guard for anything else.
    ``like``'s leaves are anything with ``shape`` and ``dtype`` (a
    ``LeafSpec``, an array, a tensor on the meta device).
    """
    def fill(path, leaf):
        key = keystr(path)
        if key not in flat:
            if key not in optional_leaves:
                raise KeyError(f"checkpoint missing leaf {key}")
            return np.zeros(tuple(leaf.shape), host_dtype(leaf.dtype))
        return flat[key]

    return _rebuild(like, fill)


def _leaf_crc(arr: np.ndarray) -> int:
    """CRC32 of the leaf's bytes, read in place (no copy)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


class FlashCheckpoint:
    """Two-tier checkpoint store: memory (fast) + disk (persistent, async).

    ``fault_hook(path, step)`` — if given — runs right after each blob lands
    on disk (and before eviction); it is the checkpoint-layer injection
    point of a fault injector's ``on_persist``.

    ``pre_commit_hook(tmp_path, step)`` — if given — runs in the mid-write
    window: the staging directory is fully written (data + manifest) but
    ``_commit`` has not renamed it yet. It is the injection point of a
    process fault injector's ``on_pre_commit`` (kill-during-checkpoint-write
    chaos): a process killed inside the hook must leave nothing that
    ``valid_steps``/``restore`` would count as a checkpoint.
    """

    def __init__(self, persist_dir: Optional[str] = None, *,
                 keep: int = 2, async_persist: bool = True,
                 fault_hook: Optional[Callable[[str, int], None]] = None,
                 pre_commit_hook: Optional[Callable[[str, int], None]] = None):
        self.persist_dir = persist_dir
        self.keep = keep
        self.async_persist = async_persist
        self.fault_hook = fault_hook
        self.pre_commit_hook = pre_commit_hook
        self._mem: Dict[int, Dict[str, np.ndarray]] = {}
        self._mem_order: List[int] = []
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: List[Future] = []
        self._lock = threading.Lock()
        self.last_save_seconds = 0.0      # memory-tier latency (critical path)
        self.last_persist_seconds = 0.0   # disk-tier latency (off critical path)
        self.last_restore_seconds = 0.0
        self.events: List[Dict] = []      # skipped dirs, corrupt-blob fallbacks
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)

    def _event(self, kind: str, **detail) -> None:
        self.events.append({"kind": kind, "t": time.time(), **detail})

    def note(self, kind: str, **detail) -> None:
        """Record an externally-observed event into this store's log.

        Public seam for callers (the supervisor's restore fallbacks) so
        their recovery decisions land next to the store's own skip/corrupt
        records instead of vanishing.
        """
        self._event(kind, **detail)
        logger.warning("flash_checkpoint %s: %s", kind, detail)

    # ------------------------------------------------------------------ save
    def save(self, state, step: int) -> None:
        t0 = time.perf_counter()
        flat = _flatten(state)
        with self._lock:
            if step in self._mem:                # re-save: refresh recency,
                self._mem_order.remove(step)     # never double-count for keep
            self._mem[step] = flat
            self._mem_order.append(step)
            while len(self._mem_order) > self.keep:
                old = self._mem_order.pop(0)
                self._mem.pop(old, None)
        self.last_save_seconds = time.perf_counter() - t0
        if self.persist_dir:
            if self.async_persist:
                self._pending.append(self._pool.submit(self._persist, flat, step))
            else:
                self._persist(flat, step)

    def drop_memory_tier(self) -> None:
        """Forget every in-memory checkpoint (node-loss simulation: only the
        persisted disk tier survives a host failure)."""
        with self._lock:
            self._mem.clear()
            self._mem_order.clear()

    def _persist(self, flat: Dict[str, np.ndarray], step: int) -> None:
        t0 = time.perf_counter()
        final = os.path.join(self.persist_dir, f"ckpt_{step:012d}")
        tmp = final + f".tmp-{os.getpid()}"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _DATA_FILE), "wb") as f:
            np.savez(f, **{k: v for k, v in flat.items()})
            f.flush()
            os.fsync(f.fileno())
        manifest = {
            "format": _FORMAT, "step": int(step),
            "leaves": {k: {"crc32": _leaf_crc(v),
                           "shape": list(v.shape), "dtype": _dtype_name(v)}
                       for k, v in flat.items()},
        }
        with open(os.path.join(tmp, _MANIFEST_FILE), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if self.pre_commit_hook is not None:     # kill-during-save chaos seam
            self.pre_commit_hook(tmp, step)
        self._commit(tmp, final)
        if self.fault_hook is not None:
            self.fault_hook(final, step)
        self._evict()
        self.last_persist_seconds = time.perf_counter() - t0

    def _commit(self, tmp: str, final: str) -> None:
        """THE atomic commit point: one ``os.replace`` of the staging dir.

        Everything before this call is preparation a kill may interrupt
        freely — a leftover ``*.tmp-<pid>`` dir is skipped by
        ``_disk_steps`` and never counted by ``valid_steps``/``restore``.
        Everything after it is a fully-valid checkpoint: the data and
        manifest files were fsynced before the rename, and the parent
        directory entry is fsynced after it, so the blob either exists
        completely under its valid name or not at all — there is no state
        in between for a SIGKILL (or power loss) to expose.
        """
        if os.path.isdir(final):                 # re-persist of the same step
            shutil.rmtree(final)
        elif os.path.exists(final):              # legacy file under this name
            os.remove(final)
        os.replace(tmp, final)
        dir_fd = os.open(os.path.dirname(final) or ".", os.O_RDONLY)
        try:
            os.fsync(dir_fd)                     # durably publish the rename
        finally:
            os.close(dir_fd)

    def _evict(self) -> None:
        for old in self._disk_steps()[:-self.keep]:
            entry = os.path.join(self.persist_dir, f"ckpt_{old:012d}")
            try:
                if os.path.isdir(entry):
                    shutil.rmtree(entry)
                else:
                    os.remove(entry + ".npz")
            except OSError as e:
                self._event("evict_failed", step=old, error=str(e))

    def wait(self) -> None:
        for fut in self._pending:
            fut.result()
        self._pending.clear()

    # --------------------------------------------------------------- restore
    def _disk_steps(self) -> List[int]:
        """Steps with a plausibly-restorable disk entry, oldest first.

        Malformed entries — unparsable names, staging (``*.tmp-*``) dirs
        left by a mid-save kill, step dirs missing their manifest — are
        skipped (and logged), never raised on: one corrupt neighbor must not
        take down eviction or restore for everyone else. Content-level
        validation (checksums) happens at load time.
        """
        if not self.persist_dir or not os.path.isdir(self.persist_dir):
            return []
        steps = []
        for name in sorted(os.listdir(self.persist_dir)):
            full = os.path.join(self.persist_dir, name)
            if not name.startswith("ckpt_"):
                continue
            if ".tmp-" in name:
                self._event("skip_staging_dir", name=name)
                continue
            if name.endswith(".npz"):            # legacy single-file blob
                try:
                    steps.append(int(name[5:-4]))
                except ValueError:
                    self._event("skip_malformed", name=name)
                continue
            try:
                step = int(name[5:])
            except ValueError:
                self._event("skip_malformed", name=name)
                continue
            if not os.path.exists(os.path.join(full, _MANIFEST_FILE)):
                self._event("skip_missing_manifest", name=name)
                continue
            steps.append(step)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        with self._lock:
            mem = max(self._mem) if self._mem else None
        disk = self._disk_steps()
        best = max([s for s in [mem, disk[-1] if disk else None] if s is not None],
                   default=None)
        return best

    def valid_steps(self) -> List[int]:
        """Disk steps that fully verify (manifest + checksums), oldest first."""
        out = []
        for step in self._disk_steps():
            try:
                self._load_disk(step)
                out.append(step)
            except CheckpointCorruptError as e:
                self._event("corrupt_blob_skipped", step=step, error=str(e))
        return out

    def _load_disk(self, step: int) -> Dict[str, np.ndarray]:
        """Load + verify one persisted step; raises ``CheckpointCorruptError``."""
        dirpath = os.path.join(self.persist_dir, f"ckpt_{step:012d}")
        legacy = dirpath + ".npz"
        if not os.path.isdir(dirpath):
            if os.path.exists(legacy):           # pre-hardening format
                try:
                    with np.load(legacy) as z:
                        return {k: z[k] for k in z.files}
                except Exception as e:
                    raise CheckpointCorruptError(
                        f"legacy blob {legacy} unreadable: {e}") from e
            raise FileNotFoundError(f"no disk blob for step {step}")
        try:
            with open(os.path.join(dirpath, _MANIFEST_FILE)) as f:
                manifest = json.load(f)
            with np.load(os.path.join(dirpath, _DATA_FILE)) as z:
                flat = {k: z[k] for k in z.files}
        except Exception as e:
            raise CheckpointCorruptError(
                f"step {step} blob unreadable: {e}") from e
        want = manifest.get("leaves", {})
        if set(want) != set(flat):
            raise CheckpointCorruptError(
                f"step {step} leaf set mismatch: manifest has {len(want)}, "
                f"data has {len(flat)}")
        for key, meta in want.items():
            if _leaf_crc(flat[key]) != meta["crc32"]:
                raise CheckpointCorruptError(
                    f"step {step} leaf {key} failed CRC32 verification")
        return flat

    def restore(self, like, step: Optional[int] = None, *,
                optional_leaves: Tuple[str, ...] = ()) -> Tuple[Any, int]:
        """Restore ``like``'s tree as host numpy arrays, and the step used.

        With ``step=None``, candidates are tried newest-first across both
        tiers; a corrupt disk blob is logged (``self.events``) and skipped,
        so the newest *valid* checkpoint wins automatically. An explicitly
        requested ``step`` that fails verification raises
        ``CheckpointCorruptError`` instead — the caller asked for that exact
        blob, silently substituting another would be wrong.

        ``optional_leaves`` names (by keystr) the specific leaves of
        ``like`` that may be absent from the blob and zero-fill — the
        schema-evolution escape hatch; every other missing leaf still
        raises (see ``_unflatten``). The returned arrays may be the memory
        tier's own: copy them before changing them in place.
        """
        t0 = time.perf_counter()
        with self._lock:
            mem_steps = set(self._mem)
        if step is not None:
            candidates = [step]
        else:
            candidates = sorted(mem_steps | set(self._disk_steps()),
                                reverse=True)
        if not candidates:
            raise FileNotFoundError("no checkpoint available")
        flat = None
        used_step = None
        for s in candidates:
            with self._lock:
                flat = self._mem.get(s)
            if flat is not None:
                used_step = s
                break
            try:
                flat = self._load_disk(s)
                used_step = s
                break
            except CheckpointCorruptError as e:
                if step is not None:
                    raise
                self._event("corrupt_blob_fallback", step=s, error=str(e))
            except FileNotFoundError:
                if step is not None:
                    raise
        if flat is None:
            raise FileNotFoundError(
                "no valid checkpoint available "
                f"(all {len(candidates)} candidate(s) corrupt or missing)")
        state = _unflatten(like, flat, optional_leaves=optional_leaves)
        self.last_restore_seconds = time.perf_counter() - t0
        return state, used_step
