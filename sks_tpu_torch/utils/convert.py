"""Carry state across from the JAX package: configs in, results out.

What carries across is the ``RansacConfig``, the pose graph, the BA problem,
the input arrays (ESM has no parameters: it carries images and a start
homography) and the learned models' flax parameters.  Arrays pass as numpy
(``torch.as_tensor``); configs, graphs and problems pass as plain mappings,
e.g. ``dataclasses.asdict`` of a ``sks_tpu.robust.RansacConfig``, a
``sks_tpu.slam.PoseGraph`` or a ``sks_tpu.slam.BAProblem``; a flax parameter
tree as nested mappings of arrays.  An optimizer's state does not carry.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np

import torch

from sks_tpu_torch.models.deep_homography import HomographyNet
from sks_tpu_torch.models.iterative import IterativeHomographyNet
from sks_tpu_torch.robust.ransac import RansacConfig, RansacResult
from sks_tpu_torch.slam.ba import BAProblem
from sks_tpu_torch.slam.posegraph import PoseGraph

__all__ = ["ransac_config_from", "result_to_numpy", "posegraph_from",
           "ba_problem_from", "homography_net_state_from", "ihn_state_from"]


def ransac_config_from(mapping: Mapping) -> RansacConfig:
    """The port's ``RansacConfig`` from a mapping of its fields.

    Raises ``ValueError`` on a field the port's config does not have, so a
    config that grew a field on one side cannot be carried across silently.
    """
    known = {f.name for f in dataclasses.fields(RansacConfig)}
    unknown = sorted(set(mapping) - known)
    if unknown:
        raise ValueError(f"RansacConfig has no field(s) {unknown}")
    return RansacConfig(**mapping)


def result_to_numpy(res: RansacResult) -> dict[str, np.ndarray]:
    """A ``RansacResult`` as a dict of numpy arrays, keyed by field name."""
    return {
        f.name: getattr(res, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(res)
    }


def posegraph_from(mapping: Mapping) -> PoseGraph:
    """The port's ``PoseGraph`` from a mapping of its four fields (poses,
    edges, meas, weights) as arrays, e.g. ``dataclasses.asdict`` of the JAX
    package's ``PoseGraph`` with its arrays passed through ``np.asarray``.

    Dtypes are kept (edges become int64 indices), on the CPU.  Raises
    ``ValueError`` unless the fields are exactly the port's.
    """
    out = _fields_of(PoseGraph, mapping)
    out["edges"] = out["edges"].long()
    return PoseGraph(**out)


def ba_problem_from(mapping: Mapping) -> BAProblem:
    """The port's ``BAProblem`` from a mapping of its five fields (poses,
    points, intrinsics, obs, mask) as arrays, e.g. ``dataclasses.asdict`` of
    the JAX package's ``BAProblem`` with its arrays passed through
    ``np.asarray``.

    Dtypes are kept, on the CPU.  Raises ``ValueError`` unless the fields are
    exactly the port's.
    """
    return BAProblem(**_fields_of(BAProblem, mapping))


def _fields_of(cls, mapping: Mapping) -> dict:
    """``mapping``'s arrays as CPU tensors keyed by the fields of the
    dataclass ``cls``; raises ``ValueError`` unless the keys are exactly
    those fields."""
    known = [f.name for f in dataclasses.fields(cls)]
    if sorted(mapping) != sorted(known):
        raise ValueError(f"a {cls.__name__} has the fields {known}; got "
                         f"{sorted(mapping)}")
    # A copy: arrays of the JAX package come through numpy read-only.
    return {k: torch.tensor(np.asarray(mapping[k])) for k in known}


def homography_net_state_from(params: Mapping) -> dict:
    """A ``state_dict`` for the port's ``HomographyNet()`` (64 x 64 pairs)
    from the JAX package's flax parameter tree ``{'params': {'Conv_0'..
    'Conv_2', 'Dense_0', 'Dense_1'}}``, each ``{'kernel', 'bias'}`` (numpy
    or JAX arrays).

    Conv kernels (kh, kw, in, out) become (out, in, kh, kw) and dense
    kernels (in, out) become (out, in); ``Dense_0``'s rows stay in the H, W,
    C order in which both packages flatten the feature map.  Raises
    ``ValueError`` on a missing or extra leaf or a shape the module does not
    have.
    """
    names = {f"Conv_{i}": f"convs.{i}" for i in range(3)}
    names.update(Dense_0="dense0", Dense_1="dense1")
    return _flax_state(_params_of(params), names, HomographyNet())


def ihn_state_from(params: Mapping, dim: int = 64) -> dict:
    """A ``state_dict`` for the port's ``IterativeHomographyNet(dim)`` from
    the JAX package's flax parameter tree ``{'params': {'_Encoder_0':
    {Conv_0, Conv_1}, '_Update_0': {Conv_0, Conv_1, Dense_0, Dense_1}}}``;
    kernels transposed and leaves checked as in
    :func:`homography_net_state_from`."""
    tree = _params_of(params)
    names = {"_Encoder_0/Conv_0": "encoder.conv0",
             "_Encoder_0/Conv_1": "encoder.conv1",
             "_Update_0/Conv_0": "update.conv0",
             "_Update_0/Conv_1": "update.conv1",
             "_Update_0/Dense_0": "update.dense0",
             "_Update_0/Dense_1": "update.dense1"}
    flat = {f"{outer}/{inner}": leaf
            for outer, sub in tree.items() for inner, leaf in
            (sub.items() if isinstance(sub, Mapping) and sub
             else [("", sub)])}
    return _flax_state(flat, names, IterativeHomographyNet(dim, iters=1))


def _params_of(tree) -> Mapping:
    """The ``'params'`` collection of a flax variable tree."""
    if not isinstance(tree, Mapping) or sorted(tree) != ["params"]:
        raise ValueError(f"expected a flax tree {{'params': ...}}; got "
                         f"{_keys(tree)}")
    return tree["params"]


def _flax_state(layers: Mapping, names: dict, like: torch.nn.Module) -> dict:
    """``layers`` (flax layer name -> {'kernel', 'bias'}) as a state_dict
    with ``like``'s keys and shapes, through ``names`` (flax -> torch
    prefix); raises ``ValueError`` on any mismatch."""
    if sorted(layers) != sorted(names):
        raise ValueError(f"expected the layers {sorted(names)}; got "
                         f"{sorted(layers)}")
    want = like.state_dict()
    out = {}
    for flax_name, prefix in names.items():
        leaves = layers[flax_name]
        if not isinstance(leaves, Mapping) or sorted(leaves) != ["bias",
                                                                 "kernel"]:
            raise ValueError(f"{flax_name}: expected the leaves ['bias', "
                             f"'kernel']; got {_keys(leaves)}")
        kernel = torch.tensor(np.asarray(leaves["kernel"]))
        kernel = (kernel.permute(3, 2, 0, 1) if kernel.dim() == 4
                  else kernel.T)
        for leaf, value in (("weight", kernel),
                            ("bias", torch.tensor(np.asarray(
                                leaves["bias"])))):
            key = f"{prefix}.{leaf}"
            if value.shape != want[key].shape:
                raise ValueError(f"{flax_name}: {leaf} of shape "
                                 f"{tuple(value.shape)} where the module "
                                 f"has {tuple(want[key].shape)}")
            out[key] = value.contiguous()
    return out


def _keys(x) -> list:
    return sorted(x) if isinstance(x, Mapping) else [type(x).__name__]
