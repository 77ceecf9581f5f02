"""Metric fetch fan-out (the JAX package's ``monitor/fetcher.py``).

Reference: ``monitor/sampling/MetricFetcherManager.java:35-223`` — a pool of
sampling threads each fetching its assigned partition set per sampling
round — and ``DefaultMetricSamplerPartitionAssignor.java`` (round-robin
assignment of partitions to fetchers).  Ingest math is vectorized here, but
the FETCH side is network-bound exactly like the reference's, so the fan-out
survives: N fetcher threads drain disjoint transport-partition sets in
parallel, and the combined raw batch feeds one vectorized processor pass.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import threading
from typing import Dict, List, Optional, Sequence

from cruise_control_tpu_torch.monitor.samples import CruiseControlMetric
from cruise_control_tpu_torch.monitor.sampler import (
    CruiseControlMetricsProcessor,
    SamplerResult,
)
from cruise_control_tpu_torch.reporter.serde import deserialize_metric
from cruise_control_tpu_torch.reporter.transport import Transport

LOG = logging.getLogger(__name__)


class DefaultMetricSamplerPartitionAssignor:
    """Round-robin partitions over fetchers
    (DefaultMetricSamplerPartitionAssignor.java:62)."""

    @staticmethod
    def assign(num_partitions: int, num_fetchers: int) -> List[List[int]]:
        sets: List[List[int]] = [[] for _ in range(max(num_fetchers, 1))]
        for p in range(num_partitions):
            sets[p % len(sets)].append(p)
        return sets


class ConsumingMetricSampler:
    """MetricSampler SPI impl consuming the reporter wire via the transport.

    The reference's consumer-based ``CruiseControlMetricsReporterSampler``:
    poll serialized raw metrics, deserialize, hand the batch to
    ``CruiseControlMetricsProcessor``.  Fetching fans out across
    ``num_fetchers`` threads with the round-robin partition assignor.
    """

    def __init__(self, transport: Transport, num_fetchers: int = 4,
                 processor: Optional[CruiseControlMetricsProcessor] = None,
                 offsets_path: Optional[str] = None):
        self.transport = transport
        self.num_fetchers = max(1, num_fetchers)
        self.processor = processor or CruiseControlMetricsProcessor()
        # Committed consumer positions (the reference sampler's Kafka
        # consumer-group offsets): without them a DURABLE transport would be
        # re-ingested from offset 0 on every restart — a day of stale raw
        # metrics folded into the current window and re-persisted by the
        # sample store.  None = in-memory only (in-process transports).
        self._offsets_path = offsets_path
        self._offsets: Dict[int, int] = {}
        if offsets_path and os.path.exists(offsets_path):
            try:
                with open(offsets_path, encoding="utf-8") as f:
                    self._offsets = {int(k): int(v)
                                     for k, v in json.load(f).items()}
            except (OSError, ValueError):
                LOG.warning("unreadable consumer-offsets file %s; consuming "
                            "from the log start", offsets_path, exc_info=True)
        self._lock = threading.Lock()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.num_fetchers, thread_name_prefix="metric-fetcher")

    def _commit_offsets(self) -> None:
        if not self._offsets_path:
            return
        with self._lock:
            snapshot = dict(self._offsets)
        tmp = self._offsets_path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(snapshot, f)
            os.replace(tmp, self._offsets_path)
        except OSError:
            LOG.warning("failed to commit consumer offsets to %s",
                        self._offsets_path, exc_info=True)

    def _fetch_partitions(self, partitions: Sequence[int],
                          start_ms: float, end_ms: float) -> List[CruiseControlMetric]:
        out: List[CruiseControlMetric] = []
        for p in partitions:
            with self._lock:
                offset = self._offsets.get(p, 0)
            records, next_offset = self.transport.poll(p, offset)
            with self._lock:
                self._offsets[p] = next_offset
            for rec in records:
                try:
                    m = deserialize_metric(rec)
                except Exception:
                    LOG.warning("undecodable metric record on partition %d", p,
                                exc_info=True)
                    from cruise_control_tpu_torch.obsvc.fidelity import fidelity
                    fidelity().on_dropped("undecodable")
                    continue
                if m is not None:
                    # No window filter: offsets only advance once, so late
                    # records are folded into the current batch rather than
                    # dropped (the aggregator's window accounting buckets by
                    # the batch close time, as the reference sampler does).
                    out.append(m)
        return out

    def get_samples(self, metadata, start_ms: float, end_ms: float) -> SamplerResult:
        with self._lock:
            pre_fetch = dict(self._offsets)
        assignment = DefaultMetricSamplerPartitionAssignor.assign(
            self.transport.num_partitions, self.num_fetchers)
        futures = [self._pool.submit(self._fetch_partitions, parts, start_ms, end_ms)
                   for parts in assignment if parts]
        raw: List[CruiseControlMetric] = []
        for f in concurrent.futures.as_completed(futures):
            raw.extend(f.result())
        if not raw:
            self._commit_offsets()
            return SamplerResult()
        try:
            result = self.processor.process(metadata, raw, end_ms)
        except Exception:
            # At-least-once: roll the IN-MEMORY positions back too — with
            # only the durable file kept, the next tick in this process
            # would fetch from the advanced positions and then commit them,
            # silently dropping the failed interval.
            with self._lock:
                self._offsets = pre_fetch
            raise
        # Commit AFTER successful processing (the Kafka consumer pattern the
        # reference relies on).
        self._commit_offsets()
        return result

    def close(self) -> None:
        self._pool.shutdown(wait=False)
