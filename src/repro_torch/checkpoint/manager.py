"""Atomic, keep-k checkpoint manager (numpy container format).

Port of ``repro.checkpoint.manager`` with the same on-disk format: one
``arrays.npz`` of ``leaf_<i>`` arrays, ``meta.json`` with per-leaf dtype
names and a crc32 over the leaves' bytes, and the ``feed.json`` sidecar.
Leaves are numbered in jax's flatten order (dict keys sorted, tuples in field
order; ``repro_torch.tree``), so a checkpoint the reference wrote restores
into the port and the other way round. bfloat16 leaves are stored as their
raw bytes (uint8), as the reference stores dtypes numpy lacks.

Fault-tolerance contract:
  * writes go to ``<dir>/tmp.step_N`` and are atomically renamed to
    ``<dir>/step_N`` — a crash mid-save never corrupts the latest checkpoint;
  * ``latest_step``/``restore`` skip unfinished tmp dirs, so restart always
    resumes from the newest COMPLETE checkpoint;
  * ``keep`` newest checkpoints are retained, older ones garbage-collected
    only after a successful save (never delete-then-write); the newest
    complete checkpoint is never GC'd;
  * a content checksum guards against partial/bit-rotted files; a ``restore``
    asked for the *latest* checkpoint falls back to the previous complete one
    when the newest fails validation (an explicitly requested step never
    falls back — the caller named it);
  * ``feed_state`` (a ``repro.data.Feed.checkpoint()`` dict) is saved as a
    sidecar INSIDE the checkpoint dir, so data-plane cursor and model state
    publish atomically together — the exactly-once resume contract (§10)
    needs them to name the same step.
"""
from __future__ import annotations

import json
import shutil
import zlib
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array as stored in the npz, dtype name recorded in meta.json)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint8).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, a.dtype.name


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    if a.dtype.name != dtype_name:
        a = a.view(np.dtype(dtype_name))
    return torch.from_numpy(a.copy())


def _treedef(tree: Any) -> str:
    """A readable structure string (informational; restore checks counts)."""
    return str(tree_map(lambda _: "*", tree))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- save -------------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[dict] = None,
             feed_state: Optional[dict] = None) -> Path:
        leaves = tree_leaves(state)
        stored = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)}
        tmp = self.dir / f"tmp.step_{step:09d}"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        # npz can't represent bfloat16: raw bytes + the dtype name
        dtypes = {k: dt for k, (_, dt) in stored.items()}
        arrays = {k: a for k, (a, _) in stored.items()}
        np.savez(tmp / "arrays.npz", **arrays)
        crc = 0
        for name in sorted(arrays):
            crc = zlib.crc32(arrays[name].tobytes(), crc)
        meta = {
            "step": step,
            "treedef": _treedef(state),
            "n_leaves": len(arrays),
            "dtypes": dtypes,
            "crc32": crc & 0xFFFFFFFF,
            "extra": extra or {},
        }
        (tmp / "meta.json").write_text(json.dumps(meta))
        if feed_state is not None:
            # sidecar written BEFORE the atomic rename: model state and feed
            # cursor publish together or not at all
            (tmp / "feed.json").write_text(json.dumps(feed_state))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and \
                    (p / "meta.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def feed_state(self, step: Optional[int] = None) -> Optional[dict]:
        """The data-plane cursor saved atomically with ``step`` (default:
        latest), or ``None`` when that checkpoint carried no feed sidecar.
        Pass it to ``repro_torch.data.open_feed(resume_from=...)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        p = self.dir / f"step_{step:09d}" / "feed.json"
        if not p.exists():
            return None
        return json.loads(p.read_text())

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Any, int, dict]:
        """Restore into the structure of ``template``: dict nodes become
        plain dicts, tuples keep their type, and each leaf lands on its
        template leaf's device (the CPU for non-tensor template leaves).

        With ``step=None`` (resume-from-latest), a checkpoint that fails
        validation (bit rot, torn write that survived the rename) falls back
        to the next older COMPLETE checkpoint — crashing the restart on the
        newest file's corruption would make one bad disk block fatal. The
        newest failure is re-raised only when every checkpoint is bad. An
        EXPLICIT ``step`` never falls back."""
        if step is not None:
            return self._restore_step(template, step)
        steps = self.all_steps()
        assert steps, "no checkpoint found"
        first_err: Optional[Exception] = None
        for s in reversed(steps):
            try:
                return self._restore_step(template, s)
            except Exception as e:
                if first_err is None:
                    first_err = e
        raise first_err  # type: ignore[misc]

    def _restore_step(self, template: Any, step: int
                      ) -> Tuple[Any, int, dict]:
        path = self.dir / f"step_{step:09d}"
        meta = json.loads((path / "meta.json").read_text())
        with np.load(path / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}
        crc = 0
        for name in sorted(arrays):
            crc = zlib.crc32(arrays[name].tobytes(), crc)
        if (crc & 0xFFFFFFFF) != meta["crc32"]:
            raise IOError(f"checkpoint {path} failed checksum validation")
        n = len(tree_leaves(template))
        if n != meta["n_leaves"]:
            raise ValueError(f"tree structure changed: template has {n} "
                             f"leaves, checkpoint {meta['n_leaves']}")
        dtypes = meta.get("dtypes", {})
        index = iter(range(n))

        def load(leaf):
            k = f"leaf_{next(index)}"
            t = _from_numpy(arrays[k], dtypes.get(k, arrays[k].dtype.name))
            dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            return t.to(dev)

        return tree_map(load, template), step, meta["extra"]
