"""Device-mesh helpers for position-axis sharding."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


POS_AXIS = "pos"


def position_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the position (sequence) axis.

    Chromosome-scale inputs are sharded along positions, shard k on the
    k-th device in ``jax.devices()`` order. The sweep's cross-shard traffic
    is all_gathers of O(P * K^2) scalars, so the order only has to be
    stable; the cards of one host are joined all to all by NVLink, so no
    order is closer than another.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (POS_AXIS,))
