"""Resource taxonomy.

Mirrors the reference's ``common/Resource.java:18-97``: four resources with
host/broker scoping.  Here a resource is just an index into axis -1 of every
load/capacity tensor, so the enum is an ``IntEnum`` and the scoping tables
are plain numpy arrays indexed by resource id.
"""

from __future__ import annotations

import enum

import numpy as np

NUM_RESOURCES = 4


class Resource(enum.IntEnum):
    """CPU is host- and broker-scoped; NW_IN/NW_OUT host-scoped; DISK broker-scoped."""

    CPU = 0
    NW_IN = 1
    NW_OUT = 2
    DISK = 3

    @property
    def resource(self) -> str:
        return _NAMES[self.value]


_NAMES = ("cpu", "networkInbound", "networkOutbound", "disk")

# Scoping masks, indexable by resource id.
IS_HOST_RESOURCE = np.array([True, True, True, False])
IS_BROKER_RESOURCE = np.array([True, False, False, True])
