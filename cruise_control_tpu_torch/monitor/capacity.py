"""Broker capacity resolution.

Reference: ``config/BrokerCapacityConfigResolver.java`` SPI and
``config/BrokerCapacityConfigFileResolver.java`` (JSON file with per-broker
overrides, JBOD logdir capacities, num cores; broker id -1 is the default
entry; capacities may be flagged as estimated).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol

import numpy as np

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource

DEFAULT_CAPACITY_BROKER_ID = -1


@dataclass
class BrokerCapacityInfo:
    capacity: np.ndarray                     # f64[4]
    disk_capacities: Optional[List[float]] = None   # JBOD logdirs
    num_cores: int = 1
    estimated: bool = False
    estimation_info: str = ""


class BrokerCapacityConfigResolver(Protocol):
    def capacity_for_broker(self, rack: str, host: str, broker_id: int,
                            allow_estimation: bool = True) -> BrokerCapacityInfo: ...


class FixedBrokerCapacityResolver:
    """Same capacity for every broker (tests / homogeneous clusters)."""

    def __init__(self, capacity: Dict[Resource, float],
                 disk_capacities: Optional[List[float]] = None,
                 num_cores: int = 1):
        arr = np.zeros(NUM_RESOURCES)
        for k, v in capacity.items():
            arr[int(k)] = v
        self._info = BrokerCapacityInfo(capacity=arr,
                                        disk_capacities=disk_capacities,
                                        num_cores=num_cores)

    def capacity_for_broker(self, rack: str, host: str, broker_id: int,
                            allow_estimation: bool = True) -> BrokerCapacityInfo:
        return self._info


class BrokerCapacityConfigFileResolver:
    """JSON-file resolver (BrokerCapacityConfigFileResolver.java:1-333).

    File schema (mirrors the reference's capacity.json family)::

        {"brokerCapacities": [
           {"brokerId": -1, "capacity": {"CPU": "100", "NW_IN": "...",
            "NW_OUT": "...", "DISK": "..."}},                       # default
           {"brokerId": 0,  "capacity": {"DISK": {"/mnt/i01": "250000",
            "/mnt/i02": "250000"}, ...}, "numCores": 8},            # override
        ]}
    """

    _KEYS = {"CPU": Resource.CPU, "NW_IN": Resource.NW_IN,
             "NW_OUT": Resource.NW_OUT, "DISK": Resource.DISK}

    def __init__(self, path: str):
        with open(path) as f:
            doc = json.load(f)
        self._by_broker: Dict[int, BrokerCapacityInfo] = {}
        for entry in doc.get("brokerCapacities", []):
            bid = int(entry["brokerId"])
            cap = np.zeros(NUM_RESOURCES)
            disks: Optional[List[float]] = None
            for key, val in entry.get("capacity", {}).items():
                res = self._KEYS[key]
                if isinstance(val, dict):   # JBOD: logdir -> capacity
                    disks = [float(v) for v in val.values()]
                    cap[int(res)] = sum(disks)
                else:
                    cap[int(res)] = float(val)
            self._by_broker[bid] = BrokerCapacityInfo(
                capacity=cap, disk_capacities=disks,
                num_cores=int(entry.get("numCores", 1)),
                estimated=bid == DEFAULT_CAPACITY_BROKER_ID,
                estimation_info=("default capacity entry"
                                 if bid == DEFAULT_CAPACITY_BROKER_ID else ""))
        if DEFAULT_CAPACITY_BROKER_ID not in self._by_broker:
            raise ValueError(
                f"capacity config must define the default entry "
                f"(brokerId={DEFAULT_CAPACITY_BROKER_ID})")

    def capacity_for_broker(self, rack: str, host: str, broker_id: int,
                            allow_estimation: bool = True) -> BrokerCapacityInfo:
        info = self._by_broker.get(broker_id)
        if info is not None:
            return info
        default = self._by_broker[DEFAULT_CAPACITY_BROKER_ID]
        if not allow_estimation:
            raise ValueError(
                f"no explicit capacity for broker {broker_id} and "
                "estimation is disallowed")
        return default


class BrokerEnvCapacityResolver:
    """Environment-variable resolver (the reference's
    ``BrokerCapacityResolver`` provider family: capacity from deployment env
    rather than a file — e.g. containerized brokers exporting
    ``BROKER_CPU_CAPACITY``/``BROKER_NW_IN_CAPACITY``/... at startup)."""

    _ENV_KEYS = {"BROKER_CPU_CAPACITY": Resource.CPU,
                 "BROKER_NW_IN_CAPACITY": Resource.NW_IN,
                 "BROKER_NW_OUT_CAPACITY": Resource.NW_OUT,
                 "BROKER_DISK_CAPACITY": Resource.DISK}

    def __init__(self, env: Optional[Dict[str, str]] = None):
        import os
        env = dict(os.environ if env is None else env)
        cap = np.zeros(NUM_RESOURCES)
        missing = []
        for key, res in self._ENV_KEYS.items():
            if key in env:
                cap[int(res)] = float(env[key])
            else:
                missing.append(key)
        if missing:
            raise ValueError(f"missing capacity env vars: {missing}")
        self._info = BrokerCapacityInfo(capacity=cap, disk_capacities=None,
                                        num_cores=int(env.get("BROKER_NUM_CORES", 1)))

    def capacity_for_broker(self, rack: str, host: str, broker_id: int,
                            allow_estimation: bool = True) -> BrokerCapacityInfo:
        return self._info


class TopicConfigDiskCapacityResolver:
    """Per-broker disk capacity learned from the cluster's own reported
    log-dir sizes plus a headroom factor (the reference's topic-config
    provider family: capacity derived from the managed system's metadata
    instead of static config).  Non-disk resources fall back to a base
    resolver."""

    def __init__(self, base: BrokerCapacityConfigResolver,
                 observed_disk_by_broker: Dict[int, float],
                 headroom_factor: float = 1.25):
        self.base = base
        self.observed = dict(observed_disk_by_broker)
        self.headroom = headroom_factor

    def capacity_for_broker(self, rack: str, host: str, broker_id: int,
                            allow_estimation: bool = True) -> BrokerCapacityInfo:
        info = self.base.capacity_for_broker(rack, host, broker_id,
                                             allow_estimation)
        observed = self.observed.get(broker_id)
        if observed is None or not allow_estimation:
            # Observed-usage capacity IS an estimation — honor the caller's
            # allow_estimation=False by returning only configured values.
            return info
        cap = np.array(info.capacity, copy=True)
        target = max(cap[int(Resource.DISK)], observed * self.headroom)
        disks = info.disk_capacities
        if disks is not None and cap[int(Resource.DISK)] > 0:
            # JBOD: the model derives broker DISK from the per-logdir sum,
            # so the raise must be applied to the logdirs proportionally.
            scale = target / cap[int(Resource.DISK)]
            disks = [d * scale for d in disks]
        cap[int(Resource.DISK)] = target
        return BrokerCapacityInfo(capacity=cap,
                                  disk_capacities=disks,
                                  num_cores=info.num_cores,
                                  estimated=True,
                                  estimation_info="observed disk + headroom")
