"""Checkpoint/resume for long SfM runs.

Port of ``sks_tpu/slam/checkpoint.py`` (orbax there): a state is any nest of
dataclasses (``BAProblem``, ``PoseGraph``), dicts, lists, tuples, tensors
and plain numbers, saved at a step as one ``torch.save`` file,
``directory/<step>/state.pt``.  The file holds plain containers and CPU
tensors only (dataclasses become dicts of their fields), so it loads with
``torch.load(weights_only=True)``; :func:`restore_state` rebuilds the
template's structure and puts each tensor back on the template's device.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping
from pathlib import Path

import torch

__all__ = ["save_state", "restore_state", "latest_step"]

_FILE = "state.pt"


def _plain(state):
    """``state`` as nested dicts, lists and tuples of CPU tensors."""
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return {f.name: _plain(getattr(state, f.name))
                for f in dataclasses.fields(state)}
    if isinstance(state, Mapping):
        return {k: _plain(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_plain(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    return state


def _rebuild(template, saved):
    """``saved`` in the structure of ``template``, each tensor with the
    template's device and dtype; raises ``ValueError`` on a mismatch."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{
            f.name: _rebuild(getattr(template, f.name), saved[f.name])
            for f in dataclasses.fields(template)})
    if isinstance(template, Mapping):
        if set(template) != set(saved):
            raise ValueError(f"checkpoint keys {sorted(saved)} != template "
                             f"keys {sorted(template)}")
        return {k: _rebuild(v, saved[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(saved):
            raise ValueError(f"checkpoint holds {len(saved)} items, the "
                             f"template {len(template)}")
        return type(template)(_rebuild(t, s) for t, s in zip(template, saved))
    if isinstance(template, torch.Tensor):
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint shape {tuple(saved.shape)} != "
                             f"template shape {tuple(template.shape)}")
        return saved.to(device=template.device, dtype=template.dtype)
    return saved


def save_state(directory, step: int, state) -> None:
    """Save ``state`` at ``step`` under ``directory`` (written to a
    temporary file, then renamed into place)."""
    path = Path(directory) / str(int(step))
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (_FILE + ".tmp")
    torch.save(_plain(state), tmp)
    os.replace(tmp, path / _FILE)


def restore_state(directory, step: int | None = None, template=None):
    """Restore the state at ``step`` (default: the latest).

    ``template``: an example state of the right structure, shapes and
    dtypes; the result has its structure (dataclasses included) and its
    tensors' devices.  Without it, nested dicts, lists and CPU tensors are
    returned.  Raises ``FileNotFoundError`` when there is no checkpoint.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    saved = torch.load(Path(directory) / str(int(step)) / _FILE,
                       weights_only=True)
    return saved if template is None else _rebuild(template, saved)


def latest_step(directory) -> int | None:
    """The largest step saved under ``directory``, or None."""
    root = Path(directory)
    if not root.is_dir():
        return None
    steps = [int(p.name) for p in root.iterdir()
             if p.name.isdigit() and (p / _FILE).is_file()]
    return max(steps, default=None)
