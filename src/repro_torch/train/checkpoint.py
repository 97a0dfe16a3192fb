"""Checkpointing: atomic save/restore + async writer, and serving snapshots.

The PyTorch counterpart of ``repro.train.checkpoint``, with its on-disk
layout, so that a checkpoint written by either package is read by the
other.  Layout per step::

    <dir>/step_000123/
        manifest.json       # step, keys, dtypes, shapes, extra
        arrays.npz          # flattened leaves (host numpy), a0, a1, ...
    <dir>/LATEST            # atomically-updated pointer file

A tree is nested dicts and lists (or tuples) with ``torch.Tensor``, numpy
or scalar leaves; ``None`` is an empty subtree.  Leaves are flattened as
``jax.tree_util.tree_flatten_with_path`` flattens them — dict keys in
sorted order, list positions in order — and each leaf's key is the
``"/"``-join of its path (``"layers/0/ffn/w_out/values2d"``).

* **Atomicity** — written to ``step_N.tmp`` then renamed; ``LATEST`` only
  advances after the rename.
* **Async** — ``save_async`` copies the leaves to host memory now and
  writes on a worker thread.
* ``restore`` returns host numpy arrays in the structure of ``tree_like``,
  as the reference's does; ``models.params_from_numpy`` carries a
  reference-layout parameter tree into a model.
* ``restore_sharded`` lays each restored leaf out on its
  ``sharding.NamedSharding``, on whatever mesh that names — the elastic
  restart onto a mesh of another shape or size.  Every rank reads the
  host copy and keeps its own slice: no scatter over the process group.

The serving snapshots (``save_snapshot`` … ``SnapshotManager``) use no
framework and are a copy of the reference's.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "save_async", "restore", "restore_sharded",
           "latest_step", "CheckpointManager", "save_snapshot",
           "restore_snapshot", "latest_snapshot", "SnapshotManager"]


def _flatten_with_keys(tree) -> Tuple[List[str], List[Any]]:
    keys: List[str] = []
    leaves: List[Any] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (str(i),))
        else:
            keys.append("/".join(path))
            leaves.append(node)

    walk(tree, ())
    return keys, leaves


def _unflatten(tree_like, leaves):
    """``tree_like``'s structure with its leaves replaced, in flattening
    order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(child) for child in node)
        return next(it)

    return build(tree_like)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: save bfloat16 tensors "
                            "as float32")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _write(ckpt_dir: str, step: int, keys, host, extra) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": a for i, a in enumerate(host)})
    manifest = {
        "step": step,
        "keys": keys,
        "dtypes": [str(a.dtype) for a in host],
        "shapes": [list(a.shape) for a in host],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _update_latest(ckpt_dir, step)
    return final


def save(ckpt_dir: str, step: int, tree, *, extra: Optional[Dict] = None):
    """Synchronous atomic checkpoint write."""
    keys, leaves = _flatten_with_keys(tree)
    return _write(ckpt_dir, step, keys, [_to_host(x) for x in leaves],
                  extra)


def _update_latest(ckpt_dir: str, step: int):
    ptr = os.path.join(ckpt_dir, "LATEST")
    tmp = ptr + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, ptr)


_EXECUTOR = concurrent.futures.ThreadPoolExecutor(max_workers=1)


def save_async(ckpt_dir: str, step: int, tree, *, extra=None):
    """Copy to host now, write on a worker thread. Returns a Future."""
    keys, leaves = _flatten_with_keys(tree)
    host = [_to_host(x) for x in leaves]       # device→host sync point
    # a CPU tensor's numpy view shares its storage: copy, so a later
    # in-place update of the tree cannot reach the pending write
    host = [a.copy() for a in host]
    return _EXECUTOR.submit(_write, ckpt_dir, step, keys, host, extra)


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        return int(f.read().strip())


def restore(ckpt_dir: str, tree_like, step: Optional[int] = None
            ) -> Tuple[Any, Dict]:
    """Restore to host numpy arrays in the structure of ``tree_like``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(final, "arrays.npz")) as data:
        host = [data[f"a{i}"] for i in range(len(manifest["keys"]))]
    keys, _ = _flatten_with_keys(tree_like)
    if keys != manifest["keys"]:
        raise ValueError(
            "checkpoint tree mismatch: "
            f"{set(keys) ^ set(manifest['keys'])} (config change?)")
    return _unflatten(tree_like, host), manifest


def restore_sharded(ckpt_dir: str, tree_like, shardings,
                    step: Optional[int] = None):
    """Restore + lay out on a (possibly different) mesh: elastic restart.

    ``shardings`` mirrors ``tree_like`` with a ``NamedSharding`` at every
    leaf; each leaf comes back as a DTensor on its sharding's mesh and
    device.  Every rank of those meshes calls it."""
    tree, manifest = restore(ckpt_dir, tree_like, step)
    keys, leaves = _flatten_with_keys(tree)
    s_keys, s_leaves = _flatten_with_keys(shardings)
    if s_keys != keys:
        raise ValueError(
            "shardings tree mismatch: "
            f"{sorted(set(keys) ^ set(s_keys))} (a NamedSharding per leaf)")
    placed = [s.distribute(np.asarray(a)) for a, s in zip(leaves, s_leaves)]
    return _unflatten(tree_like, placed), manifest


class CheckpointManager:
    """Rolling checkpoints with retention + async hand-off."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_write: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_write = async_write
        self._pending: Optional[concurrent.futures.Future] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, step: int, tree, extra=None):
        self.wait()
        self._gc()  # prune BEFORE submitting: the new write must not race GC
        if self.async_write:
            fut = save_async(self.dir, step, tree, extra=extra)
            fut.add_done_callback(lambda _: self._gc())
            self._pending = fut
        else:
            save(self.dir, step, tree, extra=extra)
            self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None
            # The done-callback's _gc runs on the executor thread and is not
            # ordered with respect to result() returning — prune here too so
            # retention is guaranteed once wait() returns.
            self._gc()

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def restore_latest(self, tree_like, shardings=None):
        self.wait()
        if shardings is None:
            return restore(self.dir, tree_like)
        return restore_sharded(self.dir, tree_like, shardings)


# ---------------------------------------------------------------------------
# serving snapshots (DESIGN.md §7.6): small JSON state dicts — session /
# router snapshot(), not parameter trees — written with the same atomic
# tmp + os.replace discipline and LATEST pointer as the step checkpoints
# ---------------------------------------------------------------------------


def save_snapshot(snap_dir: str, seq: int, state: Dict) -> str:
    """Atomic write of one serving snapshot (``snap_<seq>.json``): the
    payload lands in a ``.tmp`` first and ``os.replace`` publishes it, so
    a crash mid-write never corrupts a restore point; the ``LATEST``
    pointer only advances after the publish."""
    os.makedirs(snap_dir, exist_ok=True)
    final = os.path.join(snap_dir, f"snap_{seq:09d}.json")
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, final)
    _update_latest(snap_dir, seq)
    return final


def latest_snapshot(snap_dir: str) -> Optional[int]:
    """Sequence number of the newest published snapshot, or None."""
    return latest_step(snap_dir)


def restore_snapshot(snap_dir: str, seq: Optional[int] = None) -> Dict:
    """Load snapshot ``seq`` (default: the LATEST pointer's)."""
    if seq is None:
        seq = latest_snapshot(snap_dir)
        if seq is None:
            raise FileNotFoundError(f"no snapshot under {snap_dir}")
    with open(os.path.join(snap_dir, f"snap_{seq:09d}.json")) as f:
        return json.load(f)


class SnapshotManager:
    """Rolling serving snapshots with retention (the serving analogue of
    :class:`CheckpointManager` — synchronous, since the payload is a few
    KB of host JSON, not device arrays).  ``save(state)`` auto-increments
    the sequence; ``restore_latest()`` returns ``(state, seq)``."""

    def __init__(self, snap_dir: str, keep: int = 3):
        self.dir = snap_dir
        self.keep = keep
        os.makedirs(snap_dir, exist_ok=True)

    @property
    def next_seq(self) -> int:
        latest = latest_snapshot(self.dir)
        return 0 if latest is None else latest + 1

    def save(self, state: Dict, seq: Optional[int] = None) -> str:
        path = save_snapshot(self.dir, self.next_seq if seq is None
                             else seq, state)
        self._gc()
        return path

    def restore_latest(self) -> Tuple[Dict, int]:
        seq = latest_snapshot(self.dir)
        if seq is None:
            raise FileNotFoundError(f"no snapshot under {self.dir}")
        return restore_snapshot(self.dir, seq), seq

    def _gc(self):
        seqs = sorted(
            int(f[5:-5]) for f in os.listdir(self.dir)
            if f.startswith("snap_") and f.endswith(".json"))
        for s in seqs[: -self.keep]:
            try:
                os.remove(os.path.join(self.dir, f"snap_{s:09d}.json"))
            except OSError:
                pass
