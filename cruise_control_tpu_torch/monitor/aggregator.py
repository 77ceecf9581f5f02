"""Windowed metric-sample aggregation.

Reference: core ``aggregator/MetricSampleAggregator.java:84-400`` (cyclic
buffer of N completed windows + 1 active, generation counter, completeness
caching) and ``aggregator/RawMetricValues.java:29-351`` (per-entity ring
buffers, validity predicates, extrapolations AVG_AVAILABLE / AVG_ADJACENT /
FORECAST / NO_VALID_EXTRAPOLATION).

The JAX package's module, copied: host-side float64 numpy in both packages.
The reference keeps one synchronized RawMetricValues object per entity; here
the whole population lives in three dense planes —

    values f64[E, N+1, M]   (AVG metrics accumulate sums, MAX keep maxima,
                             LATEST keep the newest sample's value)
    counts i32[E, N+1]      samples per entity-window
    times  f64[E, N+1]      newest sample time per entity-window

— so adds are ``np.add.at`` scatters and aggregation/completeness are
vectorized mask algebra over [E, W] instead of per-entity loops.
"""

from __future__ import annotations

import enum
import logging
import threading
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np

from cruise_control_tpu_torch.common.exceptions import NotEnoughValidWindowsError
from cruise_control_tpu_torch.monitor.metric_def import MetricDef
from cruise_control_tpu_torch.obsvc.fidelity import fidelity

LOG = logging.getLogger(__name__)


class Extrapolation(enum.Enum):
    """Reference: core Extrapolation.java."""

    NONE = "none"                    # enough real samples
    AVG_AVAILABLE = "avg_available"  # some samples, fewer than required
    AVG_ADJACENT = "avg_adjacent"    # no samples; both neighbors usable
    FORECAST = "forecast"            # no samples; linear fit over history
    NO_VALID_EXTRAPOLATION = "none_valid"


@dataclass(frozen=True)
class AggregationOptions:
    """Reference: core AggregationOptions.java."""

    min_valid_entity_ratio: float = 0.0
    min_valid_entity_group_ratio: float = 0.0
    min_valid_windows: int = 1
    # Entities that must be valid regardless of ratio (include_all_topics).
    interested_entities: Optional[frozenset] = None
    # ENTITY: each entity stands alone; ENTITY_GROUP: a group (topic) is
    # invalid if any member is.
    group_granularity: bool = False


@dataclass
class MetricSampleCompleteness:
    valid_entity_ratio: float
    valid_entity_group_ratio: float
    valid_windows: List[int]
    num_entities: int
    num_valid_entities: int
    generation: int = 0
    # Valid entities that needed extrapolation for at least one window
    # (Sensors.md num-partitions-with-extrapolations).
    num_valid_entities_with_extrapolations: int = 0
    # Fidelity-fingerprint accounting over VALID entities only (the windows
    # that actually enter a model): total entity-windows considered and the
    # extrapolated ones by kind.  Defaulted so bare construction on the
    # not-enough-windows fallback path stays valid.
    num_entity_windows: int = 0
    num_windows_avg_available: int = 0
    num_windows_avg_adjacent: int = 0
    num_windows_forecast: int = 0


@dataclass
class ValuesAndExtrapolations:
    """Per-entity aggregation output: f32[M, W] + per-window extrapolations."""

    values: np.ndarray                       # f32[M, W]
    extrapolations: Dict[int, Extrapolation]  # window-list index -> kind
    windows: List[int]                        # absolute window indices (ms-based)


@dataclass
class AggregationResult:
    values_and_extrapolations: Dict[Hashable, ValuesAndExtrapolations]
    completeness: MetricSampleCompleteness


class MetricSampleAggregator:
    """Dense windowed aggregator over a dynamic entity population."""

    def __init__(
        self,
        metric_def: MetricDef,
        num_windows: int = 5,
        window_ms: int = 300_000,
        min_samples_per_window: int = 3,
        max_allowed_extrapolations_per_entity: int = 5,
        initial_capacity: int = 1024,
        group_of=None,
    ):
        self.metric_def = metric_def
        self.num_windows = num_windows
        self.window_ms = window_ms
        self.min_samples = max(min_samples_per_window, 1)
        self.max_extrapolations = max_allowed_extrapolations_per_entity
        self._group_of = group_of or (lambda e: e)
        self._lock = threading.RLock()

        m = metric_def.size
        self._slots = num_windows + 1
        cap = max(initial_capacity, 16)
        self._values = np.zeros((cap, self._slots, m), dtype=np.float64)
        self._counts = np.zeros((cap, self._slots), dtype=np.int32)
        self._times = np.full((cap, self._slots), -np.inf)
        self._slot_window = np.full(self._slots, -1, dtype=np.int64)  # abs window per slot
        self._entity_index: Dict[Hashable, int] = {}
        self._entities: List[Hashable] = []
        self._current_window = -1
        self._first_window = -1
        self._generation = 0
        strat = metric_def.strategy_vector()
        self._avg_mask = strat == 0
        self._max_mask = strat == 1
        self._latest_mask = strat == 2

    # ------------------------------------------------------------- plumbing

    @property
    def generation(self) -> int:
        return self._generation

    @property
    def current_window(self) -> int:
        """Absolute index of the active window; -1 before the first sample.
        Callers (the task runner's window-close detector) compare this
        across an ingest to see which windows just committed."""
        return self._current_window

    def _ensure_entity(self, entity: Hashable) -> int:
        idx = self._entity_index.get(entity)
        if idx is None:
            idx = len(self._entities)
            if idx >= self._values.shape[0]:
                grow = self._values.shape[0]
                self._values = np.concatenate(
                    [self._values, np.zeros_like(self._values)], axis=0)
                self._counts = np.concatenate(
                    [self._counts, np.zeros_like(self._counts)], axis=0)
                self._times = np.concatenate(
                    [self._times, np.full((grow, self._slots), -np.inf)], axis=0)
            self._entity_index[entity] = idx
            self._entities.append(entity)
        return idx

    def _roll_to(self, window: int) -> None:
        """Advance the active window, clearing reused ring slots."""
        if self._current_window < 0:
            self._current_window = window
            self._first_window = window
            self._slot_window[window % self._slots] = window
            return
        if window - self._current_window >= self._slots:
            # Time jumped past the whole ring — wipe everything.
            self._values[:] = 0.0
            self._counts[:] = 0
            self._times[:] = -np.inf
            self._slot_window[:] = [window - (window % self._slots - s) % self._slots
                                    for s in range(self._slots)]
        else:
            for w in range(self._current_window + 1, window + 1):
                s = w % self._slots
                self._values[:, s, :] = 0.0
                self._counts[:, s] = 0
                self._times[:, s] = -np.inf
                self._slot_window[s] = w
        self._current_window = max(self._current_window, window)

    # ----------------------------------------------------------------- adds

    def add_sample(self, entity: Hashable, time_ms: float,
                   metrics: np.ndarray) -> bool:
        return self.add_samples([entity], np.array([time_ms]),
                                np.asarray(metrics)[None, :]) == 1

    def add_samples(self, entities: Sequence[Hashable], times_ms: np.ndarray,
                    metrics: np.ndarray) -> int:
        """Vectorized multi-sample ingest; returns #accepted.

        Samples older than the retained window range are dropped (reference:
        addSample rejects windows that already rolled out).
        """
        with self._lock:
            windows = (np.asarray(times_ms, dtype=np.int64) // self.window_ms)
            first_ingest = self._current_window < 0
            # Windows strictly below the PRE-roll active window were already
            # closed when this batch arrived — out-of-order arrivals that
            # would otherwise scatter into committed (or recycled) window
            # buffers.  Dropped with a counter + debug log; a batch spanning
            # several windows (including the one it advances past) is fine.
            closed_before = self._current_window
            newest = int(windows.max(initial=self._current_window))
            if newest > self._current_window:
                self._roll_to(newest)
            oldest_kept = self._current_window - self.num_windows
            ok = windows >= max(oldest_kept, 0)
            if not first_ingest:
                late = windows < closed_before
                if late.any():
                    n_late = int(late.sum())
                    LOG.debug(
                        "dropping %d out-of-order sample(s) for already-"
                        "closed windows (< %d)", n_late, closed_before)
                    fidelity().on_dropped("out_of_order", n_late)
                    ok &= ~late
            if not ok.any():
                return 0
            # Track the oldest window that ever ACCEPTED a sample: a batched
            # first ingest must count from its oldest window, not the newest
            # one _roll_to saw (later batches can no longer backfill closed
            # windows — the out-of-order drop above rejects them).
            accepted_oldest = int(windows[ok].min())
            if first_ingest or accepted_oldest < self._first_window:
                self._first_window = max(accepted_oldest, 0)
            idx = np.fromiter((self._ensure_entity(e) for e in entities),
                              dtype=np.int64, count=len(entities))[ok]
            slots = (windows % self._slots)[ok]
            vals = np.asarray(metrics, dtype=np.float64)[ok]
            t = np.asarray(times_ms, dtype=np.float64)[ok]

            # NB: ufunc.at must target the real array — boolean fancy indexing
            # first would scatter into a copy.
            if self._avg_mask.any():
                cols = np.nonzero(self._avg_mask)[0]
                np.add.at(self._values,
                          (idx[:, None], slots[:, None], cols[None, :]),
                          vals[:, self._avg_mask])
            if self._max_mask.any():
                cols = np.nonzero(self._max_mask)[0]
                np.maximum.at(self._values,
                              (idx[:, None], slots[:, None], cols[None, :]),
                              vals[:, self._max_mask])
            if self._latest_mask.any():
                order = np.argsort(t, kind="stable")  # last write = newest
                newer = t[order] >= self._times[idx[order], slots[order]]
                io, so = idx[order][newer], slots[order][newer]
                self._values[io[:, None], so[:, None],
                             np.nonzero(self._latest_mask)[0][None, :]] = \
                    vals[order][newer][:, self._latest_mask]
            np.add.at(self._counts, (idx, slots), 1)
            np.maximum.at(self._times, (idx, slots), t)
            self._generation += 1
            return int(ok.sum())

    # ------------------------------------------------------------ aggregate

    def _window_range(self, from_ms: float, to_ms: float) -> List[int]:
        """Completed windows intersecting [from, to] (active one excluded)."""
        if self._current_window < 0:
            return []
        lo = 0 if from_ms == -np.inf else int(from_ms // self.window_ms)
        hi = (self._current_window if to_ms == np.inf
              else int(to_ms // self.window_ms))
        # Clamp to the first-observed window: with absolute epoch window
        # indices the ring "positions" before the first sample never existed,
        # so they must not count as (trivially-valid) completed windows.
        oldest = max(self._current_window - self.num_windows,
                     self._first_window, 0)
        start = max(lo, oldest)
        end = min(hi, self._current_window - 1)
        return list(range(start, end + 1))

    def _entity_window_planes(self, windows: List[int]):
        """(per-window collapsed values f32[E, W, M], counts i32[E, W])."""
        slots = [w % self._slots for w in windows]
        e_n = len(self._entities)
        vals = self._values[:e_n][:, slots, :].copy()
        counts = self._counts[:e_n][:, slots]
        if self._avg_mask.any():
            denom = np.maximum(counts, 1)[:, :, None]
            vals[:, :, self._avg_mask] = vals[:, :, self._avg_mask] / denom
        return vals, counts

    def aggregate(self, from_ms: float, to_ms: float,
                  options: Optional[AggregationOptions] = None) -> AggregationResult:
        """Reference: MetricSampleAggregator.aggregate :193-240."""
        options = options or AggregationOptions()
        with self._lock:
            windows = self._window_range(from_ms, to_ms)
            if len(windows) < options.min_valid_windows:
                raise NotEnoughValidWindowsError(
                    f"{len(windows)} completed windows in range, "
                    f"need {options.min_valid_windows}")
            vals, counts = self._entity_window_planes(windows)
            e_n, w_n, m = vals.shape

            # --- validity & extrapolation per entity-window --------------
            full = counts >= self.min_samples                       # [E, W]
            some = (counts > 0) & ~full                             # AVG_AVAILABLE
            empty = counts == 0
            # AVG_ADJACENT: both neighbors (within selection) have samples.
            left = np.roll(counts, 1, axis=1) > 0
            left[:, 0] = False
            right = np.roll(counts, -1, axis=1) > 0
            right[:, -1] = False
            adjacent = empty & left & right
            # FORECAST: any earlier window with samples.
            has_prior = np.cumsum(counts, axis=1) - counts > 0
            forecast = empty & ~adjacent & has_prior
            invalid = empty & ~adjacent & ~forecast

            # Fill AVG_ADJACENT values: mean of neighbors.
            if adjacent.any():
                lv = np.roll(vals, 1, axis=1)
                rv = np.roll(vals, -1, axis=1)
                fill = (lv + rv) / 2.0
                vals = np.where(adjacent[:, :, None], fill, vals)
            # Fill FORECAST values: weighted linear fit over the most recent
            # prior non-empty windows (reference RawMetricValues FORECAST —
            # least-squares over up to 5 earlier windows), vectorized with
            # prefix sums restricted to the entities that need it.  A single
            # prior point degenerates to carry-forward (slope 0).
            if forecast.any():
                rows = np.nonzero(forecast.any(axis=1))[0]
                v = vals[rows].astype(np.float64)            # [E', W, M]
                nonempty = counts[rows] > 0                  # [E', W]
                x = np.arange(w_n, dtype=np.float64)[None, :]
                xm = np.where(nonempty, x, 0.0)
                nm = nonempty.astype(np.float64)
                ym = np.where(nonempty[:, :, None], v, 0.0)

                def last5_prior(a):
                    """Sum of a over the 5 windows preceding each w."""
                    pad_shape = (a.shape[0], 1) + a.shape[2:]
                    cum = np.concatenate(
                        [np.zeros(pad_shape, a.dtype), np.cumsum(a, axis=1)],
                        axis=1)                              # cum[:, w] = sum < w
                    lo = np.maximum(np.arange(w_n) - 5, 0)
                    return cum[:, np.arange(w_n)] - cum[:, lo]

                n_p = last5_prior(nm)                        # [E', W]
                sx_p = last5_prior(xm)
                sxx_p = last5_prior(xm * xm)
                sy_p = last5_prior(ym)                       # [E', W, M]
                sxy_p = last5_prior(xm[:, :, None] * ym)
                denom = n_p * sxx_p - sx_p ** 2              # [E', W]
                safe = np.maximum(denom, 1e-12)[:, :, None]
                slope = np.where((denom > 1e-12)[:, :, None],
                                 (n_p[:, :, None] * sxy_p
                                  - sx_p[:, :, None] * sy_p) / safe, 0.0)
                n_safe = np.maximum(n_p, 1.0)[:, :, None]
                intercept = (sy_p - slope * sx_p[:, :, None]) / n_safe
                pred = np.maximum(intercept + slope * x[:, :, None], 0.0)
                # Classification (has_prior) looks back unboundedly; when the
                # nearest non-empty window is >5 back (n_p == 0) the fit has
                # no points — fall back to carrying the last value forward.
                carried = v.copy()
                seen = nonempty.copy()
                for w in range(1, w_n):
                    need = ~seen[:, w]
                    carried[need, w, :] = carried[need, w - 1, :]
                    seen[:, w] |= seen[:, w - 1]
                pred = np.where((n_p > 0)[:, :, None], pred, carried)
                sel = forecast[rows][:, :, None]
                vals[rows] = np.where(sel, pred, vals[rows])

            num_extrapolated = (some | adjacent | forecast).sum(axis=1)
            entity_valid = (~invalid).all(axis=1) & (
                num_extrapolated <= self.max_extrapolations)
            # By-kind extrapolation counts over VALID entities (the windows
            # that actually enter a model) — fidelity-fingerprint inputs.
            valid_rows = entity_valid[:, None]
            n_avg_available = int((some & valid_rows).sum())
            n_avg_adjacent = int((adjacent & valid_rows).sum())
            n_forecast = int((forecast & valid_rows).sum())

            # --- completeness --------------------------------------------
            groups: Dict[Hashable, bool] = {}
            for i, e in enumerate(self._entities):
                g = self._group_of(e)
                groups[g] = groups.get(g, True) and bool(entity_valid[i])
            ratio = float(entity_valid.sum()) / max(e_n, 1)
            gratio = (sum(groups.values()) / max(len(groups), 1)) if groups else 0.0
            completeness = MetricSampleCompleteness(
                valid_entity_ratio=ratio, valid_entity_group_ratio=gratio,
                valid_windows=windows, num_entities=e_n,
                num_valid_entities=int(entity_valid.sum()),
                generation=self._generation,
                num_valid_entities_with_extrapolations=int(
                    (entity_valid & (num_extrapolated > 0)).sum()),
                num_entity_windows=int(entity_valid.sum()) * w_n,
                num_windows_avg_available=n_avg_available,
                num_windows_avg_adjacent=n_avg_adjacent,
                num_windows_forecast=n_forecast)
            if ratio < options.min_valid_entity_ratio:
                raise NotEnoughValidWindowsError(
                    f"valid entity ratio {ratio:.3f} < "
                    f"{options.min_valid_entity_ratio}")
            if gratio < options.min_valid_entity_group_ratio:
                raise NotEnoughValidWindowsError(
                    f"valid group ratio {gratio:.3f} < "
                    f"{options.min_valid_entity_group_ratio}")

            out: Dict[Hashable, ValuesAndExtrapolations] = {}
            interested = options.interested_entities
            for i, e in enumerate(self._entities):
                if not entity_valid[i]:
                    continue
                if interested is not None and e not in interested:
                    continue
                ext: Dict[int, Extrapolation] = {}
                for w in range(w_n):
                    if some[i, w]:
                        ext[w] = Extrapolation.AVG_AVAILABLE
                    elif adjacent[i, w]:
                        ext[w] = Extrapolation.AVG_ADJACENT
                    elif forecast[i, w]:
                        ext[w] = Extrapolation.FORECAST
                out[e] = ValuesAndExtrapolations(
                    values=vals[i].T.astype(np.float32), extrapolations=ext,
                    windows=list(windows))
            return AggregationResult(values_and_extrapolations=out,
                                     completeness=completeness)

    def completeness(self, from_ms: float, to_ms: float,
                     options: Optional[AggregationOptions] = None
                     ) -> MetricSampleCompleteness:
        try:
            return self.aggregate(from_ms, to_ms, options).completeness
        except NotEnoughValidWindowsError:
            return MetricSampleCompleteness(
                valid_entity_ratio=0.0, valid_entity_group_ratio=0.0,
                valid_windows=[], num_entities=len(self._entities),
                num_valid_entities=0, generation=self._generation)

    # -------------------------------------------------------------- queries

    def all_entities(self) -> List[Hashable]:
        with self._lock:
            return list(self._entities)

    def num_available_windows(self) -> int:
        """Completed windows observed since the first sample (the window index
        is absolute ``time_ms // window_ms``, so count from the first-observed
        window, not from zero)."""
        with self._lock:
            if self._current_window < 0:
                return 0
            return min(self.num_windows, self._current_window - self._first_window)

    def retain_entities(self, keep) -> None:
        """Drop entities not in ``keep`` (topology change cleanup)."""
        with self._lock:
            keep_idx = [i for i, e in enumerate(self._entities) if e in keep]
            if len(keep_idx) == len(self._entities):
                return
            sel = np.asarray(keep_idx, dtype=np.int64)
            e_new = [self._entities[i] for i in keep_idx]
            n = self._values.shape[0]
            new_vals = np.zeros_like(self._values)
            new_counts = np.zeros_like(self._counts)
            new_times = np.full_like(self._times, -np.inf)
            new_vals[:len(sel)] = self._values[sel]
            new_counts[:len(sel)] = self._counts[sel]
            new_times[:len(sel)] = self._times[sel]
            self._values, self._counts, self._times = new_vals, new_counts, new_times
            self._entities = e_new
            self._entity_index = {e: i for i, e in enumerate(e_new)}
            self._generation += 1
