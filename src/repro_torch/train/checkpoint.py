"""Fault-tolerant checkpointing: atomic, content-verified, async — the
reference's layout, for the port's trees of tensors.

Layout:  <dir>/step_<n>/
             arrays.npz           (flat {path: array})
             manifest.json        (step, shapes, dtypes, checksums)
             COMMITTED            (sentinel — written last, after fsync)

Keys are the tree paths joined by ``/`` (dict keys and list indices, in
``jax.tree`` order).  numpy has no bfloat16 without ``ml_dtypes``, so a
bf16 tensor is stored as its raw ``uint16`` bits, with ``"dtype":
"bfloat16"`` in the manifest; its crc32 is over those bits.

Crash-safety: everything is staged in ``step_<n>.tmp`` and renamed into
place; a checkpoint without the COMMITTED sentinel is ignored by
``latest_step`` and garbage-collected.  ``AsyncCheckpointer`` snapshots
device tensors to host and writes on a background thread so the step loop
never blocks on disk.

Across ranks (a tree of DTensors) every rank saves: each takes part in
gathering every leaf whole, rank 0 alone keeps the gathered leaves and
writes them, the others drop each one at once, and every rank returns
once the checkpoint is committed.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.context import is_dtensor
from .tree import leaves_with_paths

_SEP = "/"
_BF16 = "bfloat16"


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _to_host(x) -> np.ndarray:
    """A copy of a tensor (or array) as a numpy array, bf16 as its uint16
    bits — a copy, since a tensor may be written in place after the
    snapshot.  A DTensor is gathered whole first (a collective: every rank
    of its mesh calls this), so a checkpoint holds no layout."""
    if is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        bf16 = x.dtype == torch.bfloat16
        x = x.detach().view(torch.int16) if bf16 else x.detach()
        host = x.cpu().numpy()
        if x.device.type == "cpu":       # .cpu() returned the tensor itself
            host = host.copy()
        return host.view(np.uint16) if bf16 else host
    return np.array(x)


def _ranks() -> bool:
    return dist.is_available() and dist.is_initialized()


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a group, or a
    process without one."""
    return not _ranks() or dist.get_rank() == 0


def _flatten(tree, keep: bool = True) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """({key: host array}, {key: dtype name}) — the dtype is ``bfloat16``
    for a bf16 leaf stored as bits.  ``keep`` False (a rank that does not
    write): each DTensor leaf is still gathered, since every rank of its
    mesh must take part, and dropped at once; nothing is returned."""
    flat, dtypes = {}, {}
    for path, leaf in leaves_with_paths(tree):
        if not keep:
            if is_dtensor(leaf):
                leaf.full_tensor()
            continue
        key = _key(path)
        flat[key] = _to_host(leaf)
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        dtypes[key] = _BF16 if bf16 else str(flat[key].dtype)
    return flat, dtypes


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a)) & 0xFFFFFFFF


def _from_host(arr: np.ndarray, dtype: str, like, device=None) -> Any:
    """The stored array back as a tensor like the template leaf (its dtype,
    and its device unless ``device`` is given).  The tensor may share
    ``arr``'s memory."""
    arr = np.require(arr, requirements=("C", "W"))
    if dtype == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(device=device if device is not None else like.device, dtype=like.dtype)
    return t


def _unflatten(template, flat: Dict[str, np.ndarray], dtypes: Dict[str, str], device=None):
    paths = dict(leaves_with_paths(template))
    keyed = {_key(p): p for p in paths}
    values = {keyed[k]: _from_host(flat[k], dtypes[k], paths[keyed[k]], device) for k in keyed}

    def rebuild(node, prefix=()):
        if isinstance(node, dict):
            return {k: rebuild(v, prefix + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, prefix + (i,)) for i, v in enumerate(node))
        return values[prefix]

    return rebuild(template)


def _save_flat(directory: Path, step: int, flat, dtypes) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    np.savez(tmp / "arrays.npz", **flat)
    manifest = {
        "step": step,
        "arrays": {
            k: {"shape": list(v.shape), "dtype": dtypes[k], "crc32": _crc(v)}
            for k, v in flat.items()
        },
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    with open(tmp / "COMMITTED", "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def save_checkpoint(directory: str | Path, step: int, tree: Any) -> Path:
    """Write ``tree`` as step ``step``.  Across ranks every rank calls
    this (see the module's docstring)."""
    writer = _writer()
    flat, dtypes = _flatten(tree, keep=writer)
    path = Path(directory) / f"step_{step:08d}"
    if writer:
        path = _save_flat(Path(directory), step, flat, dtypes)
    if _ranks():
        dist.barrier()
    return path


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for d in directory.iterdir():
        if d.name.startswith("step_") and not d.name.endswith(".tmp"):
            if (d / "COMMITTED").exists():
                steps.append(int(d.name.split("_")[1]))
            # uncommitted (crashed mid-write): ignore
    return max(steps) if steps else None


def restore_checkpoint(
    directory: str | Path, template: Any, step: Optional[int] = None,
    *, verify: bool = True, device=None,
) -> Tuple[int, Any]:
    """(step, tree): the tree has ``template``'s structure, and each leaf
    its template leaf's dtype, and its device unless ``device`` is given
    (a template of ``meta`` tensors holds shapes and dtypes only)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as z:
        flat = {k: z[k] for k in z.files}
    if verify:
        for k, meta in manifest["arrays"].items():
            if _crc(flat[k]) != meta["crc32"]:
                raise IOError(f"checkpoint corruption: crc mismatch for {k!r}")
    dtypes = {k: meta["dtype"] for k, meta in manifest["arrays"].items()}
    return step, _unflatten(template, flat, dtypes, device)


def gc_checkpoints(directory: str | Path, keep: int = 3) -> None:
    directory = Path(directory)
    if not directory.exists():
        return
    committed = sorted(
        d for d in directory.iterdir()
        if d.name.startswith("step_") and (d / "COMMITTED").exists()
    )
    for d in committed[:-keep]:
        shutil.rmtree(d, ignore_errors=True)
    for d in directory.iterdir():  # crashed partial writes
        if d.name.endswith(".tmp"):
            shutil.rmtree(d, ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot-to-host + background write; wait() before process exit.
    ``snapshot_s`` and ``write_s`` hold the last save's two parts (the
    copy to host, on the caller's thread; the write, on the background
    thread).  Across ranks every rank calls ``save`` and ``wait`` (see the
    module's docstring): rank 0 writes, and ``wait`` returns on every rank
    once the checkpoint is committed."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending_barrier = False
        self.snapshot_s: Optional[float] = None
        self.write_s: Optional[float] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()  # one in flight at a time
        writer = _writer()
        t0 = time.perf_counter()
        flat, dtypes = _flatten(tree, keep=writer)  # snapshot NOW
        self.snapshot_s = time.perf_counter() - t0
        self._pending_barrier = _ranks()
        if not writer:
            return

        def work():
            try:
                t1 = time.perf_counter()
                _save_flat(self.directory, step, flat, dtypes)
                gc_checkpoints(self.directory, self.keep)
                self.write_s = time.perf_counter() - t1
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending_barrier:
            self._pending_barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

