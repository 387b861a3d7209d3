"""Checkpointing over nested dicts of tensors (port of
``repro.checkpoint.manager``): per-leaf ``.npy`` files plus a JSON
manifest with integrity hashes, and optional background writes.

Crash safety: every save builds the full checkpoint under a ``.tmp``
sibling and publishes it with one atomic ``rename``; the manifest is
written through a temp file + ``os.replace`` and carries a content
digest (sha256 over the per-leaf hash table), so a kill mid-save never
leaves a half-written checkpoint, and a flipped byte anywhere in the
data or the manifest raises ``CorruptCheckpointError`` on restore.

numpy has no bfloat16 here, so a bfloat16 leaf is stored as its
``uint16`` bit view with ``"bfloat16"`` in the manifest: the sha256
digests cover the real bits.  Leaves are named by their key path
joined with ``__``, as the JAX package names them.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..tree import tree_flatten_with_path, tree_unflatten


class CorruptCheckpointError(IOError):
    """A checkpoint failed integrity verification: a leaf's bytes do not
    match its manifest sha256, the manifest's content digest does not
    match its leaf table, or a leaf file is missing or unreadable."""


def _leaf_name(path) -> str:
    return "__".join(str(k) for k in path) or "leaf"


def _content_digest(leaves: dict) -> str:
    canon = json.dumps(leaves, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


def _write_manifest(directory: pathlib.Path, manifest: dict,
                    fsync: bool = False) -> None:
    tmp = directory / "manifest.json.tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(manifest, indent=1))
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, directory / "manifest.json")


def _to_host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """(host copy to store, dtype name for the manifest).  The copy is
    the caller's to keep: a background write never sees later updates."""
    t = leaf.detach()
    name = "bfloat16" if t.dtype == torch.bfloat16 else None
    if name:
        t = t.view(torch.int16)
    arr = t.cpu().numpy()
    if leaf.device.type == "cpu":
        arr = arr.copy()   # .numpy() of a CPU tensor shares its memory
    if name:
        return arr.view(np.uint16), name
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, like: torch.Tensor) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def _snapshot(tree) -> list[tuple[str, np.ndarray, str]]:
    return [(_leaf_name(path), *_to_host(leaf))
            for path, leaf in tree_flatten_with_path(tree)]


def _save_host(leaves, directory: pathlib.Path, extra: Optional[dict],
               fsync: bool) -> dict:
    directory = pathlib.Path(directory)
    tmp = directory.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest: dict[str, Any] = {"leaves": {}, "extra": extra or {},
                                "time": time.time()}
    for name, arr, dtype in leaves:
        fn = f"{name}.npy"
        np.save(tmp / fn, arr)
        if fsync:
            fd = os.open(tmp / fn, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        manifest["leaves"][name] = {
            "file": fn, "shape": list(arr.shape), "dtype": dtype,
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
        }
    manifest["digest"] = _content_digest(manifest["leaves"])
    _write_manifest(tmp, manifest, fsync=fsync)
    if directory.exists():
        shutil.rmtree(directory)
    tmp.rename(directory)   # atomic publish
    return manifest


def save_tree(tree, directory: pathlib.Path, extra: Optional[dict] = None,
              fsync: bool = False) -> dict:
    return _save_host(_snapshot(tree), directory, extra, fsync)


def load_manifest(directory: pathlib.Path) -> dict:
    """Read and integrity-check a checkpoint manifest."""
    directory = pathlib.Path(directory)
    try:
        manifest = json.loads((directory / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CorruptCheckpointError(
            f"unreadable manifest under {directory}: {e}") from e
    if _content_digest(manifest["leaves"]) != manifest.get("digest"):
        raise CorruptCheckpointError(
            f"manifest content digest mismatch under {directory}")
    return manifest


def _load_leaf(directory: pathlib.Path, name: str, meta: dict,
               verify: bool = True) -> np.ndarray:
    try:
        arr = np.load(directory / meta["file"])
    except (OSError, ValueError) as e:
        raise CorruptCheckpointError(
            f"unreadable leaf {name} under {directory}: {e}") from e
    if verify and hashlib.sha256(arr.tobytes()).hexdigest() != meta["sha256"]:
        raise CorruptCheckpointError(f"checkpoint corruption in {name}")
    return arr


def restore_tree(tree_like, directory: pathlib.Path, *, shardings=None,
                 verify: bool = True):
    """Restore into the structure of ``tree_like``; each leaf takes the
    device and dtype of its counterpart there.  ``verify=False`` skips
    the per-leaf sha256 (the manifest's digest is always checked).
    ``shardings``: a matching tree of ``parallel.sharding.Sharding``
    (mesh and placements) for re-placement under a (possibly different)
    mesh: each leaf is read whole and verified, then this rank keeps its
    shard (``distribute_tensor`` from the leaf every rank read)."""
    directory = pathlib.Path(directory)
    manifest = load_manifest(directory)
    flat = tree_flatten_with_path(tree_like)
    if shardings is None:
        sh_flat = [None] * len(flat)
    else:
        sh_paths = tree_flatten_with_path(shardings)
        for (path, _), (sh_path, _) in itertools.zip_longest(flat, sh_paths,
                                                             fillvalue=(None, None)):
            if path != sh_path:
                name = (lambda q: "nothing" if q is None else _leaf_name(q))
                raise ValueError(f"shardings do not match the tree: leaf {name(path)} "
                                 f"against the shardings' {name(sh_path)}")
        sh_flat = [sh for _, sh in sh_paths]

    def restore(path, like, sh):
        name = _leaf_name(path)
        meta = manifest["leaves"][name]
        arr = _load_leaf(directory, name, meta, verify)
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(like.shape)}")
        leaf = _from_host(arr, meta["dtype"], like)
        if sh is None:
            return leaf
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(leaf.to(sh.mesh.device_type), sh.mesh, list(sh.placements),
                                 src_data_rank=None)

    return tree_unflatten(tree_like, [restore(path, like, sh) for (path, like), sh
                                      in zip(flat, sh_flat)])


class CheckpointManager:
    """Step-indexed checkpoints under root/step_{n}; keeps the newest
    ``keep``; optional background writer thread; ``fsync=True`` forces
    data to disk before the atomic publish."""

    def __init__(self, root, keep: int = 3, async_save: bool = True,
                 fsync: bool = False):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self.fsync = fsync
        self._thread: Optional[threading.Thread] = None

    def step_dir(self, step: int) -> pathlib.Path:
        return self.root / f"step_{step:08d}"

    def _steps_on_disk(self) -> list:
        # an in-flight save's "step_N.tmp" must not count
        steps = []
        for p in self.root.glob("step_*"):
            suffix = p.name.split("_", 1)[1]
            if p.is_dir() and suffix.isdigit():
                steps.append(int(suffix))
        return sorted(steps)

    def steps(self) -> list:
        self.wait()
        return self._steps_on_disk()

    def latest_step(self) -> Optional[int]:
        steps = self._steps_on_disk()
        return steps[-1] if steps else None

    def verify(self, step: int) -> bool:
        """True iff the checkpoint at ``step`` passes full verification."""
        self.wait()
        d = self.step_dir(step)
        try:
            for name, meta in load_manifest(d)["leaves"].items():
                _load_leaf(d, name, meta)
        except (CorruptCheckpointError, KeyError):
            return False
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, extra: Optional[dict] = None) -> None:
        # copy to host memory now; write in the background
        leaves = _snapshot(tree)
        extra = dict(extra or {}, step=step)

        def work():
            _save_host(leaves, self.step_dir(step), extra, self.fsync)
            self._gc()

        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, tree_like, step: Optional[int] = None, shardings=None):
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.step_dir(step)
        tree = restore_tree(tree_like, d, shardings=shardings)
        return tree, load_manifest(d)["extra"]

    def _gc(self) -> None:
        for s in self._steps_on_disk()[:-self.keep]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
