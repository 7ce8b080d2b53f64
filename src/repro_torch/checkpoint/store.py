"""Checkpoint store, as in the JAX package's ``repro.checkpoint.store``:

  * **atomic**: write to ``<dir>/tmp.<step>/`` then ``os.rename``, so a crash
    mid-save never corrupts the latest complete checkpoint;
  * **integrity**: a crc32 per array in a JSON manifest, verified on load;
  * **async**: ``save_async`` copies the tree to host memory before it
    returns and writes the files on a background thread.  The copy is what
    makes it safe here: the port's optimizer updates parameters and states
    in place, so the next step would otherwise overwrite what the writer
    is still reading (JAX arrays are immutable and need no copy);
  * **keep-k**: old steps are removed after a successful save.

A tree is a tensor or a nested dict/list/tuple of tensors; leaves are keyed
by JAX's ``keystr`` form of their path (``[0]['layers.0.attn.wq.w']``).
numpy has no bfloat16, so a bf16 tensor is stored as its raw 16-bit
pattern and the manifest names its dtype; ``load_checkpoint`` rebuilds it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Optional

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint", "latest_step"]

_MANIFEST = "manifest.json"
# dtypes numpy cannot hold, stored as their raw bits
_RAW = {torch.bfloat16: np.int16}


def _keyed(tree, path: str = ""):
    """(path, leaf) pairs in JAX's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keyed(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _keyed(v, f"{path}[{i}]")
    else:
        yield path, tree


def _unflatten(like, values: dict, path: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], values, f"{path}[{k!r}]") for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, values, f"{path}[{i}]") for i, v in enumerate(like))
    return values[path]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def host_snapshot(tree) -> dict:
    """{path: (numpy array, dtype name)}: a host copy of every leaf, taken
    now (device tensors are copied to host; host tensors are cloned)."""
    out = {}
    for key, leaf in _keyed(tree):
        t = torch.as_tensor(leaf).detach()
        name = _dtype_name(t.dtype)
        t = t.cpu() if t.is_cuda else t.clone()
        if t.dtype in _RAW:
            t = t.view(torch.int16)
        out[key] = (t.contiguous().numpy(), name)
    return out


def _write(directory: str, step: int, arrays: dict, extra: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "arrays": {}, "extra": extra or {}}
    for key, (arr, dtype) in arrays.items():
        fname = f"a{len(manifest['arrays']):06d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["arrays"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype,
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF,
        }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree, extra: Optional[dict] = None) -> str:
    """Synchronous atomic save.  Returns the final step directory."""
    return _write(directory, step, host_snapshot(tree), extra)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
            os.path.join(directory, name, _MANIFEST)
        ):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def load_checkpoint(directory: str, like_tree, step: Optional[int] = None):
    """Load into the structure of ``like_tree``: each leaf comes back as a
    new tensor with the like leaf's dtype and device.  Verifies checksums.
    Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    values = {}
    likes = dict(_keyed(like_tree))
    for key, meta in manifest["arrays"].items():
        arr = np.load(os.path.join(d, meta["file"]))
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF
        if crc != meta["crc32"]:
            raise IOError(f"checksum mismatch for {key} in {d}")
        t = torch.from_numpy(arr)
        dtype = getattr(torch, meta["dtype"])
        if dtype in _RAW:
            t = t.view(dtype)
        if key in likes:
            like = torch.as_tensor(likes[key])
            values[key] = t.to(device=like.device, dtype=like.dtype)
    missing = [k for k in likes if k not in values]
    if missing:
        raise KeyError(f"checkpoint missing {missing[0]}")
    return _unflatten(like_tree, values), manifest["step"], manifest["extra"]


class CheckpointManager:
    """Async keep-k checkpointing around a directory."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree, extra: Optional[dict] = None):
        """Copy the tree to host memory now (the caller may update it in
        place as soon as this returns), write the files in the background."""
        self.wait()
        arrays = host_snapshot(tree)

        def work():
            try:
                _write(self.directory, step, arrays, extra)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree, extra: Optional[dict] = None):
        self.wait()
        save_checkpoint(self.directory, step, tree, extra)
        self._gc()

    def restore(self, like_tree):
        self.wait()
        return load_checkpoint(self.directory, like_tree)

    def latest_step(self):
        return latest_step(self.directory)

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_")
        )
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)
