"""Checkpoints: save, restore and resume, and the best-model rule.

Port of `tmrnet_tpu/utils/checkpoint.py` (:21-268) with JAX's directory
layout and semantics, in torch files where JAX writes Orbax trees:

    <dir>/step_00000120/state.pt     the weights and the train state
    <dir>/step_00000120.json         {"step": 120, "metrics": {...}}
    <dir>/best/ and <dir>/best.json  a copy of the best step

`state.pt` holds the weights as a flax variables tree (`variables`:
"params" and "batch_stats" under the flax names and layouts,
`models/convert.py::to_flax_variables`, the arrays stored as tensors), so
the weight bridge reads them back, and the train state (`train`: the optimizer's state, the step, the
gradient accumulator). A step is written to a temporary directory and
renamed into place; `keep` bounds the step directories (the best is a
copy apart, which the pruning never touches); the best is replaced by a
staged copy and two renames. `restore_weights` reads the weights alone,
whatever optimizer wrote them. Files are read with
`torch.load(weights_only=True)`, which unpickles tensors and plain
containers only: a file holding any other object is refused, as
the port's other readers of untrusted files refuse one. Orbax checkpoints of the JAX package cannot
be read here: weights move between the packages as reference `.pth` files
(`models/torch_import.py`).

`use_async=True` is JAX's `AsyncCheckpointer` (:28-125): `save()` waits
for the write in flight, copies the weights, the running statistics and
the train state off the live tensors (CUDA tensors into page-locked host
memory behind an event, which the writer waits on: the next step's
in-place updates queue after the copies), and returns; a background
thread writes the step directory and then its sidecar. A best waits for
its step's write before it is copied, and `wait()` blocks until the write
is durable (a writer's error is raised there). Until its rename a step
is a `.tmp` directory that `all_steps` does not list.

`mesh=` (the grid over processes, `parallel/mesh.py`): rank 0 alone
writes, prunes and promotes the best; the others read the shared
directory. Under tensor parallelism each rank holds slices of some
parameters and of their optimizer slots (`parallel/tensor.py`): a save
gathers them whole over each model group first (every rank's collective,
`TrainState.whole_state`), so a grid's checkpoint holds whole tensors in
the one-process layout, which one process reads unchanged; a restore
under the grid cuts them to the rank's slices again, as JAX's Orbax
checkpoints hold global arrays. Every rank calls `save`,
`wait`, `barrier` and `restore` at the same points. `wait` is a
collective (a MAX over the ranks of whether a write failed), so every
rank waits on rank 0's background write, and a failed write raises on
every rank: at the start of each save and restore, before a best is
promoted, and before the trainer returns. A synchronous save ends with
the same collective, after which the step is on disk for every rank.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 use_async: bool = False, mesh=None):
        self.dir = os.path.abspath(directory)
        self.keep = keep
        self.use_async = use_async
        self.mesh = mesh
        self.primary = mesh is None or mesh.rank == 0
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self.dir, exist_ok=True)

    def wait(self) -> None:
        """Block until the write in flight is durable (at once when none
        is); raise the writer's error, once. Under a mesh, every rank
        waits for rank 0's write, and its error raises on every rank."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._error = self._error, None
        if self.barrier(failed=err is not None) and err is None:
            raise RuntimeError("rank 0's checkpoint write failed")
        if err is not None:
            raise RuntimeError("the background checkpoint write failed"
                               ) from err

    def barrier(self, failed: bool = False) -> bool:
        """Under a mesh, wait for every rank; True where any rank says
        `failed`. Without one, `failed` as given."""
        if self.mesh is None:
            return failed
        from tmrnet_torch.parallel.mesh import all_reduce_host

        return bool(all_reduce_host(np.asarray([int(failed)], np.int32),
                                    self.mesh, "max")[0])

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _meta_path(self, step: int) -> str:
        return self._step_dir(step) + ".json"

    @property
    def best_dir(self) -> str:
        return os.path.join(self.dir, "best")

    # -- save/restore -------------------------------------------------------
    @staticmethod
    def _savable(model_state: Dict[str, torch.Tensor],
                 train_state: Dict[str, Any]) -> Dict[str, Any]:
        from tmrnet_torch.models.convert import to_flax_variables

        variables = _tree_map(lambda a: torch.from_numpy(
            np.ascontiguousarray(a)), to_flax_variables(model_state))
        return {"variables": variables, "train": train_state}

    @staticmethod
    def _snapshot(model_state, train_state):
        """Copies of the model's state dict and the train state, off the
        live tensors, and the event that ends their copies from the card
        (None where nothing is on one)."""
        on_card = []

        def copy(x):
            if isinstance(x, torch.Tensor):
                x = x.detach()
                if x.device.type != "cuda":
                    return x.clone()
                on_card.append(x.device)
                out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                return out.copy_(x, non_blocking=True)
            if isinstance(x, dict):
                return {k: copy(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(copy(v) for v in x)
            return x

        model, train = copy(model_state), copy(train_state)
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(on_card[0]))
        return model, train, event

    def _write(self, step: int, model_state, train_state, meta: Dict) -> None:
        """Write a step directory through its `.tmp` and a rename, then its
        sidecar."""
        path = self._step_dir(step)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(self._savable(model_state, train_state),
                   os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        with open(self._meta_path(step), "w") as f:
            json.dump(meta, f)

    def _write_async(self, step, model_state, train_state, event, meta):
        try:
            if event is not None:
                event.synchronize()
            self._write(step, model_state, train_state, meta)
        except BaseException as e:      # raised by wait()
            self._error = e

    def save(self, state, step: int, metrics: Optional[Dict] = None,
             is_best: bool = False) -> str:
        """Write the state as step `step` with its metrics; under is_best
        also as the best. Returns the step's directory. Async: returns
        once the state is copied, the write in flight (a best waits for
        it)."""
        self.wait()
        meta = {"step": step, "metrics": metrics or {}}
        path = self._step_dir(step)
        model_state, train_state = state.whole_state()
        if not self.use_async:
            self._on_primary(lambda: (
                self._write(step, model_state, train_state, meta),
                self._promote_and_prune(step, meta, is_best)))
            return path
        if self.primary:
            self._writer = threading.Thread(
                target=self._write_async, name=f"checkpoint-{step}",
                args=(step, *self._snapshot(model_state, train_state), meta))
            self._writer.start()
        if is_best:
            self.wait()
            self._on_primary(lambda: self._promote_and_prune(step, meta, True))
        elif self.primary:
            self._gc(pending=step)
        return path

    def _on_primary(self, fn) -> None:
        """fn() on rank 0 (the only rank without a mesh), then every rank
        waits for it; its error raises there and on every other rank."""
        err = None
        if self.primary:
            try:
                fn()
            except BaseException as e:
                err = e
        if self.barrier(failed=err is not None) and err is None:
            raise RuntimeError("rank 0's checkpoint write failed")
        if err is not None:
            raise err

    def _promote_and_prune(self, step: int, meta: Dict,
                           is_best: bool) -> None:
        path = self._step_dir(step)
        if is_best:
            # stage the whole copy, then swap: a kill at any point leaves a
            # complete best (or its staged copy, which restores read)
            staged = self.best_dir + ".tmp"
            if os.path.exists(staged):
                shutil.rmtree(staged)
            shutil.copytree(path, staged)
            with open(staged + ".json", "w") as f:
                json.dump(meta, f)
            if os.path.exists(self.best_dir):
                shutil.rmtree(self.best_dir)
            os.replace(staged, self.best_dir)
            os.replace(staged + ".json", self.best_dir + ".json")
        self._gc(pending=step if self._writer is not None else None)

    def _gc(self, pending: Optional[int] = None) -> None:
        """Drop all but the newest `keep` steps. `pending`: the step whose
        write is in flight (not listed until its rename), counted and never
        dropped; then the newest durable step is kept too, so a write that
        dies leaves a whole checkpoint."""
        steps = self.all_steps()
        protect = set()
        if pending is not None:
            protect.add(pending)
            durable = [s for s in steps if s != pending]
            if durable:
                protect.add(durable[-1])
            if pending not in steps:
                steps = sorted(steps + [pending])
        for s in steps[: max(0, len(steps) - self.keep)]:
            if s in protect:
                continue
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            try:
                os.remove(self._meta_path(s))
            except OSError:
                pass

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".json"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @staticmethod
    def _load(path: str) -> Dict[str, Any]:
        """A step's saved dict, the variables as numpy arrays; a file that
        holds more than tensors and plain containers raises
        `pickle.UnpicklingError`."""
        saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                           weights_only=True)
        saved["variables"] = _tree_map(lambda t: t.numpy(),
                                       saved["variables"])
        return saved

    def restore(self, state, step: Optional[int] = None):
        """Load step `step` (default the latest) into the train state:
        weights and running statistics, optimizer state, step and
        accumulator. Returns the state."""
        from tmrnet_torch.models.convert import from_jax_variables

        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        saved = self._load(self._step_dir(step))
        state.load_whole_state(from_jax_variables(saved["variables"]),
                               saved["train"])
        return state

    def restore_weights(self) -> Dict[str, Any]:
        """The weights alone, {"params", "batch_stats"} in the flax layout
        (numpy), whatever optimizer wrote them: from best/, else its staged
        copy, else the newest step."""
        self.wait()
        path = self.best_dir
        if not os.path.exists(path):
            if os.path.exists(path + ".tmp"):
                path = path + ".tmp"
            else:
                step = self.latest_step()
                if step is None:
                    raise FileNotFoundError(f"no checkpoints in {self.dir}")
                path = self._step_dir(step)
        return self._load(path)["variables"]

    def metadata(self, step: int) -> Dict:
        """A step's metadata; {"step", "metrics": {}} where the sidecar was
        lost (the checkpoint itself is whole)."""
        try:
            with open(self._meta_path(step)) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {"step": step, "metrics": {}}

    def best_metadata(self) -> Dict:
        """The best checkpoint's metadata ({} when there is none)."""
        try:
            with open(self.best_dir + ".json") as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}


class BestTracker:
    """The reference's rule: the epoch with the highest val accuracy, ties
    broken by train accuracy."""

    def __init__(self):
        self.best_val = -1.0
        self.best_train = -1.0
        self.best_epoch = -1

    def update(self, epoch: int, val_acc: float, train_acc: float) -> bool:
        better = (val_acc > self.best_val
                  or (val_acc == self.best_val and train_acc > self.best_train))
        if better:
            self.best_val, self.best_train, self.best_epoch = (
                val_acc, train_acc, epoch)
        return better
