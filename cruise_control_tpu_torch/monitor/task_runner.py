"""Sampling scheduler & state machine.

Reference: ``monitor/task/LoadMonitorTaskRunner.java:33-353`` — states
{NOT_STARTED, RUNNING, SAMPLING, PAUSED, BOOTSTRAPPING, TRAINING, LOADING},
the periodic SamplingTask, bootstrap over a historical range (:134-184),
pause/resume (:281-311), and startup sample loading; plus the fetcher fan-out
of ``monitor/sampling/MetricFetcherManager.java:35-223`` collapsed into one
vectorized ingest (dense-array adds make per-partition fetch threads moot).
The JAX package's module.  Time comes from an injectable ``clock``, and
``run_sampling_once`` / ``bootstrap`` take explicit times.
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from typing import Optional

import numpy as np

from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
from cruise_control_tpu_torch.monitor.sampler import MetricSampler, SamplerResult
from cruise_control_tpu_torch.monitor.sample_store import NoopSampleStore, SampleStore
from cruise_control_tpu_torch.obsvc.fidelity import fidelity

LOG = logging.getLogger(__name__)


class RunnerState(enum.Enum):
    NOT_STARTED = "NOT_STARTED"
    RUNNING = "RUNNING"
    SAMPLING = "SAMPLING"
    PAUSED = "PAUSED"
    BOOTSTRAPPING = "BOOTSTRAPPING"
    TRAINING = "TRAINING"
    LOADING = "LOADING"


class LoadMonitorTaskRunner:
    def __init__(
        self,
        load_monitor: LoadMonitor,
        sampler: MetricSampler,
        sample_store: Optional[SampleStore] = None,
        sampling_interval_ms: int = 120_000,
        clock=time.time,
    ):
        self.load_monitor = load_monitor
        self.sampler = sampler
        self.sample_store = sample_store or NoopSampleStore()
        self.sampling_interval_s = sampling_interval_ms / 1000.0
        self._clock = clock
        self._state = RunnerState.NOT_STARTED
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._paused_reason: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._last_sampling_ms: float = 0.0
        # Optional broker-side reporter agents (metrics-reporter pipeline) —
        # started/stopped with the runner.
        self.reporters: list = []

    # ----------------------------------------------------------- lifecycle

    @property
    def state(self) -> RunnerState:
        with self._lock:
            return self._state

    def start(self, load_stored_samples: bool = True) -> None:
        with self._lock:
            if self._state is not RunnerState.NOT_STARTED:
                return
            self._state = RunnerState.LOADING
        if load_stored_samples:
            self._load_samples()
        with self._lock:
            if self._state is RunnerState.LOADING:
                self._state = RunnerState.RUNNING
        for reporter in self.reporters:
            reporter.start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="sampling-task")
        self._thread.start()

    def shutdown(self) -> None:
        for reporter in self.reporters:
            reporter.stop()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.sample_store.close()

    def _load_samples(self) -> None:
        """SampleLoadingTask: replay the sample store into the aggregators."""
        lm = self.load_monitor

        def on_partition(s):
            lm.partition_aggregator.add_sample(s.entity, s.time_ms, s.metrics)

        def on_broker(s):
            lm.broker_aggregator.add_sample(s.entity, s.time_ms, s.metrics)

        self.sample_store.load_samples(on_partition, on_broker)

    # ------------------------------------------------------------ sampling

    def _loop(self) -> None:
        while not self._stop.wait(min(self.sampling_interval_s, 0.2)):
            now = self._clock() * 1000
            if now - self._last_sampling_ms < self.sampling_interval_ms_effective():
                continue
            try:
                self.run_sampling_once(now)
            except Exception:   # noqa: BLE001 — a transient fetch failure
                # (network-bound samplers: prometheus down, transport IO)
                # must not kill the sampling thread; skip the tick and retry.
                LOG.warning("sampling tick failed; will retry", exc_info=True)

    def sampling_interval_ms_effective(self) -> float:
        return self.sampling_interval_s * 1000.0

    def run_sampling_once(self, now_ms: Optional[float] = None) -> int:
        """One SamplingTask tick: fetch → ingest → persist."""
        with self._lock:
            if self._state not in (RunnerState.RUNNING,):
                return 0
            self._state = RunnerState.SAMPLING
        try:
            now_ms = self._clock() * 1000 if now_ms is None else now_ms
            start = self._last_sampling_ms or (now_ms - self.sampling_interval_s * 1000)
            metadata = self.load_monitor.metadata_client.refresh_metadata()
            # MetricFetcherManager sensors (Sensors.md): per-round fetch
            # timer + failure rate.
            reg = registry()
            try:
                with reg.timer(
                        "MetricFetcherManager.partition-samples-fetcher-timer"
                ).time():
                    result = self.sampler.get_samples(metadata, start, now_ms)
            except Exception:
                reg.counter("MetricFetcherManager."
                            "partition-samples-fetcher-failure-rate").inc()
                raise
            # Fidelity observatory: per-fetch sample counts + broker-liveness
            # flap detection from the metadata this tick refreshed.
            fid = fidelity()
            fid.on_fetch(len(result.partition_samples),
                         len(result.broker_samples))
            fid.record_liveness({b.broker_id: bool(b.alive)
                                 for b in metadata.brokers}, now_ms=now_ms)
            n = self._ingest(result)
            self._last_sampling_ms = now_ms
            return n
        finally:
            with self._lock:
                if self._state is RunnerState.SAMPLING:
                    self._state = RunnerState.RUNNING

    def _ingest(self, result: SamplerResult) -> int:
        lm = self.load_monitor
        n = 0
        before = lm.partition_aggregator.current_window
        if result.partition_samples:
            entities = [s.entity for s in result.partition_samples]
            times = np.array([s.time_ms for s in result.partition_samples])
            metrics = np.stack([s.metrics for s in result.partition_samples])
            n += lm.partition_aggregator.add_samples(entities, times, metrics)
        if result.broker_samples:
            entities = [s.entity for s in result.broker_samples]
            times = np.array([s.time_ms for s in result.broker_samples])
            metrics = np.stack([s.metrics for s in result.broker_samples])
            n += lm.broker_aggregator.add_samples(entities, times, metrics)
        self.sample_store.store_samples(result.partition_samples,
                                        result.broker_samples)
        # Window-close detection: any window the ingest rolled the active
        # pointer past just committed.  Bounded to the ring span so a clock
        # jump cannot emit an unbounded event burst.
        after = lm.partition_aggregator.current_window
        if before >= 0 and after > before:
            window_ms = lm.partition_aggregator.window_ms
            span = lm.partition_aggregator.num_windows + 1
            for w in range(max(before, after - span), after):
                fidelity().on_window_close(w, window_ms)
        return n

    # ------------------------------------------------------------ bootstrap

    def bootstrap(self, start_ms: float, end_ms: float,
                  clear_metrics: bool = False) -> int:
        """Re-ingest a historical range (BootstrapTask.java:1-276)."""
        with self._lock:
            prev = self._state
            self._state = RunnerState.BOOTSTRAPPING
        try:
            n = 0
            window = self.load_monitor.partition_aggregator.window_ms
            t = start_ms
            metadata = self.load_monitor.metadata_client.refresh_metadata()
            while t < end_ms:
                result = self.sampler.get_samples(metadata, t, min(t + window, end_ms))
                # Stamp samples into their window.
                for s in result.partition_samples + result.broker_samples:
                    s.time_ms = min(t + window - 1, end_ms)
                n += self._ingest(result)
                t += window
            return n
        finally:
            with self._lock:
                self._state = prev

    # -------------------------------------------------------- pause/resume

    def pause_sampling(self, reason: str = "user requested") -> None:
        with self._lock:
            if self._state in (RunnerState.RUNNING, RunnerState.SAMPLING):
                self._state = RunnerState.PAUSED
                self._paused_reason = reason

    def resume_sampling(self, reason: str = "user requested") -> None:
        with self._lock:
            if self._state is RunnerState.PAUSED:
                self._state = RunnerState.RUNNING
                self._paused_reason = None

    @property
    def paused_reason(self) -> Optional[str]:
        return self._paused_reason
