"""Carry state across from the JAX package: configs in, results out.

The robust fit has no learned parameters; what carries across is the
``RansacConfig`` and the input arrays.  Arrays pass as numpy
(``torch.as_tensor``); configs pass as plain mappings, e.g.
``dataclasses.asdict`` of a ``sks_tpu.robust.RansacConfig``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np

from sks_tpu_torch.robust.ransac import RansacConfig, RansacResult

__all__ = ["ransac_config_from", "result_to_numpy"]


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
