"""Atomic, versioned checkpointing of trees of tensors, in the JAX
package's on-disk layout (``repro.checkpoint.manager``), so that a
checkpoint written by either package restores in the other.

Layout:
    <dir>/step_<N>/manifest.json        shapes, logical dtypes, metadata
    <dir>/step_<N>/<flat-key>.npy       one array per leaf
    <dir>/LATEST                        committed pointer (atomic rename)

A leaf's flat key is its path of dict keys and sequence indices joined by
``/`` (a NamedTuple's fields by index); its file is the key with ``/`` as
``__``.  bf16 leaves are stored as their uint16 bits, the manifest keeping
the logical dtype ``bfloat16``.

Guarantees:
* **atomicity** — a checkpoint directory is staged under ``.tmp-...`` and
  renamed into place; LATEST is updated last, also by rename.  A crash at
  any point leaves the previous checkpoint intact.
* **async** — ``save_async`` snapshots to host memory synchronously (one
  device->host copy) and writes in a background thread, overlapping the
  next training steps; ``wait()`` joins before the next save.
* **retention** — keeps the newest ``keep`` checkpoints.

The JAX package's elastic restore onto a mesh (``shardings=``) waits for
the port's ``parallel/``; ``restore(target=...)`` places every leaf on its
target leaf's device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

#: numpy's name of each tensor dtype a checkpoint holds (bf16 as its bits)
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16, torch.int64: np.int64,
              torch.int32: np.int32, torch.int16: np.int16,
              torch.int8: np.int8, torch.uint8: np.uint8,
              torch.bool: np.bool_}


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _rebuild_like(target, flat, prefix=""):
    """Rebuild ``target``'s structure from the flat key->leaf dict (walks
    exactly like _flatten, so ordering concerns never arise)."""
    if isinstance(target, dict):
        return {k: _rebuild_like(v, flat, f"{prefix}{k}/") for k, v in target.items()}
    if isinstance(target, tuple) and hasattr(target, "_fields"):  # NamedTuple
        vals = [_rebuild_like(v, flat, f"{prefix}{i}/") for i, v in enumerate(target)]
        return type(target)(*vals)
    if isinstance(target, (list, tuple)) and not hasattr(target, "shape"):
        vals = [_rebuild_like(v, flat, f"{prefix}{i}/") for i, v in enumerate(target)]
        return type(target)(vals) if isinstance(target, list) else tuple(vals)
    return flat[prefix.rstrip("/")]


def _to_host(leaf) -> tuple:
    """``(array, logical dtype)`` of a leaf: a tensor copied to the host
    (bf16 as its uint16 bits), a numpy array or Python number as it is."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)   # a snapshot, not a view
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        if t.dtype not in _NP_DTYPES:
            raise TypeError(f"checkpoint: no numpy dtype for {t.dtype}")
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(raw: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its logical dtype."""
    raw = np.array(raw, copy=True)
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(raw)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def latest_step(self) -> Optional[int]:
        pointer = os.path.join(self.dir, "LATEST")
        if not os.path.exists(pointer):
            return None
        with open(pointer) as f:
            return int(f.read().strip())

    def all_steps(self):
        return sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_")
        )

    # ------------------------------------------------------------------
    @staticmethod
    def _snapshot(tree: Any) -> Dict[str, tuple]:
        return {k: _to_host(v) for k, v in _flatten(tree).items()}

    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None) -> str:
        return self._write(step, self._snapshot(tree), metadata or {})

    def save_async(self, step: int, tree: Any, metadata: Optional[Dict] = None):
        self.wait()
        host = self._snapshot(tree)  # snapshot now
        meta = dict(metadata or {})
        self._thread = threading.Thread(
            target=self._write, args=(step, host, meta), daemon=True
        )
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: Dict[str, tuple], metadata: Dict) -> str:
        final = self._step_dir(step)
        tmp = os.path.join(self.dir, f".tmp-{step}-{os.getpid()}-{time.time_ns()}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "metadata": metadata, "arrays": {}}
        for key, (arr, logical_dtype) in host.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["arrays"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": logical_dtype,
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        ptr_tmp = os.path.join(self.dir, f".LATEST-{time.time_ns()}")
        with open(ptr_tmp, "w") as f:
            f.write(str(step))
        os.rename(ptr_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: Optional[int] = None, *, target: Any = None):
        """Load a checkpoint (the latest by default): ``(tree, metadata)``.
        Without ``target`` the tree is the flat key -> CPU tensor dict;
        with it, ``target``'s structure (dicts, lists, tuples,
        NamedTuples) over the stored leaves, each on the device of
        ``target``'s leaf there (a leaf that is no tensor: the CPU)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {key: _from_host(np.load(os.path.join(d, info["file"])),
                                info["dtype"])
                for key, info in manifest["arrays"].items()}
        if target is None:
            return flat, manifest["metadata"]
        flat_target = _flatten(target)
        if set(flat_target) != set(flat):
            raise KeyError(f"checkpoint {d} and the target differ in "
                           f"{sorted(set(flat_target) ^ set(flat))[:5]}")
        restored = {k: flat[k].to(v.device) if isinstance(v, torch.Tensor)
                    else flat[k] for k, v in flat_target.items()}
        return _rebuild_like(target, restored), manifest["metadata"]
