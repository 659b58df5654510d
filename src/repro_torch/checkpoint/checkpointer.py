"""Atomic, asynchronous checkpoints in the reference's on-disk layout.

    <dir>/step_00000120/
        META.json        -- step, each leaf's file / shape / dtype, meta
        <leaf-path>.npy  -- one file per leaf of the state tree
        DONE             -- commit marker

A state is a nested dict whose leaves are tensors or numpy arrays (the
trainer passes the reference's tree layout, ``models.weights.to_numpy_tree``),
and a leaf is named by its keys joined with "/" -- the names the reference
gives the same tree, so either package restores the other's checkpoints.
``save`` snapshots the leaves to host memory, then writes on a background
thread into a temporary directory that is renamed into place after its
``DONE`` marker: a failure mid-write never leaves a directory that looks
committed.  Only the newest ``keep`` committed steps are kept.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch

_SEP = "/"


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key in sorted(tree):
        value = tree[key]
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + _SEP))
        else:
            out[name] = value
    return out


def _host(value) -> np.ndarray:
    """A host snapshot of a tensor leaf (a copy even on the CPU, where
    ``.cpu()`` would share the live tensor's memory); a numpy leaf is taken
    as it is, as the reference takes its leaves."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True).numpy()
    return np.asarray(value)


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------ save ------------------------------

    def save(self, step: int, state: dict, *, meta: dict | None = None,
             blocking: bool = False) -> None:
        host = {k: _host(v) for k, v in _flatten(state).items()}  # snapshot
        self.wait()
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host, meta or {}),
            daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the pending write; re-raise its failure here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _write_guarded(self, step: int, host: dict, meta: dict) -> None:
        try:
            self._write(step, host, meta)
        except Exception as e:     # reported by the next wait()
            self._error = e

    def _write(self, step: int, host: dict, meta: dict) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        index = {}
        for name, arr in host.items():
            fn = name.replace(_SEP, "__") + ".npy"
            np.save(tmp / fn, arr)
            index[name] = {"file": fn, "shape": list(arr.shape),
                           "dtype": str(arr.dtype)}
        with open(tmp / "META.json", "w") as f:
            json.dump({"step": step, "leaves": index, "meta": meta}, f)
        (tmp / "DONE").touch()
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ----------------------------- restore ----------------------------

    def all_steps(self) -> list[int]:
        """Committed steps (a directory with its DONE marker), ascending."""
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if (p / "DONE").exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: dict | None = None, step: int | None = None,
                device: str | torch.device | None = None) -> tuple[int, dict]:
        """Load ``step`` (default: the latest) into the structure of
        ``template`` (a nested dict whose leaves only name what to load; by
        default every leaf of the checkpoint).  Leaves come back as tensors
        on ``device``, or as numpy arrays when no device is given.  ->
        (step, tree)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "META.json").read_text())
        if template is None:
            template = {}
            for name in meta["leaves"]:
                *keys, leaf = name.split(_SEP)
                node = template
                for key in keys:
                    node = node.setdefault(key, {})
                node[leaf] = None

        def load(node: dict, prefix: str) -> dict:
            out = {}
            for key, value in node.items():
                name = f"{prefix}{key}"
                if isinstance(value, dict):
                    out[key] = load(value, name + _SEP)
                    continue
                arr = np.load(d / meta["leaves"][name]["file"])
                out[key] = (arr if device is None
                            else torch.as_tensor(arr).to(device))
            return out

        return step, load(template, "")
