"""Checkpoints (counterpart of `escgnn_tpu/train/checkpoint.py`).

The same `CheckpointManager` API as the JAX package's orbax manager
(`save`, `restore`, `all_steps`, `latest_step`, `max_to_keep`, `close`,
and `restore_train_state`), storing each step as one `torch.save` file,
`<directory>/<step>.pt`, published atomically (written to a tmp file,
then renamed) so a reader never sees a torn one.

The JAX package's orbax checkpoints cannot be read without JAX. JAX
parameters reach the port through `weights.py` (flax trees as numpy
arrays); a checkpoint of this module holds PyTorch state-dict names.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

_FILE = re.compile(r"(\d+)\.pt")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 20):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._closed = False

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def close(self) -> None:
        """Nothing runs in the background; a closed manager refuses to
        save."""
        self._closed = True

    def save(self, step: int, tree: Any, force: bool = False) -> None:
        """Write `tree` (tensors in nested dicts and lists) as `step`. An
        existing step is overwritten only with `force`. The oldest steps
        beyond `max_to_keep` are deleted."""
        if self._closed:
            raise RuntimeError("save on a closed CheckpointManager")
        path = self._path(step)
        if os.path.exists(path) and not force:
            raise ValueError(f"checkpoint step {step} exists in "
                             f"{self.directory}; pass force=True to replace it")
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            torch.save(_to_cpu(tree), tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        for old in self.all_steps()[:-self.max_to_keep or None]:
            os.unlink(self._path(old))

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        """The tree saved as `step` (the latest when None), or None when
        there is no checkpoint. With a `template` (a tree of tensors) the
        saved tree must have its structure and shapes, and each tensor
        comes back with the template's type on its device."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        tree = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        return tree if template is None else _like(tree, template, "")

    def all_steps(self) -> list:
        steps = []
        for name in os.listdir(self.directory):
            m = _FILE.fullmatch(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _like(tree, template, where: str):
    if isinstance(template, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != template.shape:
            raise ValueError(f"checkpoint {where or 'tree'}: "
                             f"{getattr(tree, 'shape', type(tree))} does not "
                             f"match the template's {tuple(template.shape)}")
        return tree.to(template.device, template.dtype)
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError(f"checkpoint {where or 'tree'}: keys differ "
                             f"from the template's")
        return {k: _like(tree[k], v, f"{where}/{k}")
                for k, v in template.items()}
    return tree


def model_tree(model: torch.nn.Module) -> dict:
    """{'params': {name: tensor}, 'batch_stats': {name: tensor}}: the
    model's half of a train state, as the drivers checkpoint it."""
    return {"params": {k: p.detach() for k, p in model.named_parameters()},
            "batch_stats": {k: b for k, b in model.named_buffers()}}


@torch.no_grad()
def load_model_tree(model: torch.nn.Module, tree: dict) -> None:
    """Copy a `model_tree` into the model's tensors in place (a captured
    step keeps reading the same tensors). Every tensor must be named."""
    state = dict(model.named_parameters())
    state.update(model.named_buffers())
    given = {**tree["params"], **tree["batch_stats"]}
    if set(given) != set(state):
        raise ValueError(
            f"checkpoint does not match the model: missing "
            f"{sorted(set(state) - set(given))}, unused "
            f"{sorted(set(given) - set(state))}")
    for k, v in given.items():
        state[k].copy_(v)


def restore_train_state(ckpt: CheckpointManager, model: torch.nn.Module,
                        opt: Optional[torch.optim.Optimizer] = None,
                        step: Optional[int] = None) -> Optional[int]:
    """Restore a train state saved as {'params', 'batch_stats'[,
    'opt_state'][, 'step']} into `model` (and `opt`) in place. Returns the
    saved 'step' (else the checkpoint's step), or None when there is no
    checkpoint. An optimizer state that does not load (another optimizer
    or parameter layout) is left as it was: the moments restart, the
    standard degradation for a resume across formats."""
    step = ckpt.latest_step() if step is None else step
    if step is None:
        return None
    tree = ckpt.restore(step)
    load_model_tree(model, tree)
    if opt is not None and "opt_state" in tree:
        try:
            opt.load_state_dict(tree["opt_state"])
        except (ValueError, KeyError):
            pass
    return int(tree.get("step", step))


def train_state_tree(model: torch.nn.Module,
                     opt: Optional[torch.optim.Optimizer] = None,
                     step: Optional[int] = None) -> dict:
    """The tree `restore_train_state` reads: the model's tensors, and the
    optimizer's state and the step where given."""
    tree = model_tree(model)
    if opt is not None:
        tree["opt_state"] = opt.state_dict()
    if step is not None:
        tree["step"] = int(step)
    return tree
