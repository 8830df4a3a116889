"""Fault-tolerant checkpointing: atomic, async, in the JAX package's format.

Port of ``src/repro/train/checkpoint.py``:

* **atomic** — write to ``step_XXXXXXXXXX.tmp`` then ``os.rename``; a crash
  mid-write never corrupts the latest checkpoint.
* **async** — one background thread serializes and writes; the train loop
  only blocks if a previous save is still in flight (one-deep pipeline).
  The weights and the optimizer state are copied to the host before the
  thread starts, so the loop may write them in place at once.
* **data cursor** — ``extra`` (the ``TokenPipeline`` state) is kept with
  the step, so a restart neither replays nor skips batches.
* **retention** — keep the last ``keep`` checkpoints, delete older ones.

The on-disk format is the reference's: ``params.npz`` and ``opt.npz`` keyed
by the ``/``-joined path of each leaf of the JAX package's trees (the
parameters as ``init_params`` lays them out, each family's layers stacked
on a leading axis; the optimizer's ``m/...``, ``v/...`` and ``step``),
bfloat16 stored as float32, and ``meta.json``.  A checkpoint written by
either package restores into the other.

``restore`` writes into the caller's model and optimizer state in place
(no ``data_ptr`` moves).  The reference's ``shardings=`` (re-sharding
under a JAX mesh) comes with the sharding specs of Queue 1 item 9c and is
left out here.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models.transformer import leaf_of, tree_of
from repro_torch.optim.adamw import named_tensors

__all__ = ["Checkpointer"]


def _flat(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested dict of arrays -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _host_trees(params, opt_state: dict) -> dict[str, dict]:
    """The payload of one checkpoint, copied to the host now."""
    opt = {"m": tree_of(opt_state["m"].items()),
           "v": tree_of(opt_state["v"].items()),
           "step": opt_state["step"].detach().to("cpu", copy=True).numpy()}
    return {"params": _flat(tree_of(named_tensors(params).items())),
            "opt": _flat(opt)}


def _nest(flat: dict[str, np.ndarray]) -> dict:
    """{"a/b/c": array} -> the nested dict."""
    tree: dict = {}
    for key, a in flat.items():
        *path, last = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = a
    return tree


@torch.no_grad()
def _fill(named: dict[str, torch.Tensor], tree: dict, prefix: str = "") -> None:
    """Write each tensor from its leaf of ``tree`` (under ``prefix``), in
    place."""
    for name, t in named.items():
        a = leaf_of(tree, f"{prefix}.{name}" if prefix else name)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint shape mismatch at {name}: "
                             f"{a.shape} vs {tuple(t.shape)}")
        t.copy_(torch.as_tensor(a))


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, params, opt_state: dict,
             extra: dict | None = None) -> None:
        """``params`` the model (or a dict of its tensors), ``opt_state``
        ``adamw_init``'s dict; both copied to the host before this
        returns."""
        payload = _host_trees(params, opt_state)
        meta = {"step": int(step), "extra": extra or {}}
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, payload, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, payload, meta)

    def _write(self, step: int, payload: dict, meta: dict) -> None:
        name = f"step_{step:010d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        for group, flat in payload.items():
            np.savez(os.path.join(tmp, group + ".npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_") and not n.endswith(".tmp"):
                out.append(int(n.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, params, opt_state: dict, *, step: int | None = None):
        """Returns (step, params, opt_state, extra), the weights and the
        optimizer state written in place from checkpoint ``step`` (the
        latest by default)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "params.npz")) as pz:
            _fill(named_tensors(params), _nest(dict(pz)))
        with np.load(os.path.join(d, "opt.npz")) as oz:
            opt = _nest(dict(oz))
        _fill(opt_state["m"], opt, "m")
        _fill(opt_state["v"], opt, "v")
        _fill({"step": opt_state["step"]}, opt)
        return meta["step"], params, opt_state, meta["extra"]
