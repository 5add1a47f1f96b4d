"""Carry state across from the JAX package: configs in, results out.

The port has no learned parameters; what carries across is the
``RansacConfig``, the pose graph and the input arrays.  Arrays pass as numpy
(``torch.as_tensor``); configs and graphs pass as plain mappings, e.g.
``dataclasses.asdict`` of a ``sks_tpu.robust.RansacConfig`` or of a
``sks_tpu.slam.PoseGraph``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np

import torch

from sks_tpu_torch.robust.ransac import RansacConfig, RansacResult
from sks_tpu_torch.slam.posegraph import PoseGraph

__all__ = ["ransac_config_from", "result_to_numpy", "posegraph_from"]


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
    known = [f.name for f in dataclasses.fields(PoseGraph)]
    if sorted(mapping) != sorted(known):
        raise ValueError(f"a PoseGraph has the fields {known}; got "
                         f"{sorted(mapping)}")
    # A copy: arrays of the JAX package come through numpy read-only.
    out = {k: torch.tensor(np.asarray(mapping[k])) for k in known}
    out["edges"] = out["edges"].long()
    return PoseGraph(**out)
