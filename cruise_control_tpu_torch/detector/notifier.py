"""Anomaly notification / self-healing policy.

Reference: ``detector/notifier/AnomalyNotifier.java`` SPI,
``SelfHealingNotifier.java:57-148`` (broker-failure alert after 15 min,
auto-fix after 30 min; per-type self-healing enable flags),
``NoopNotifier``, and ``SlackSelfHealingNotifier`` → the
``WebhookSelfHealingNotifier`` below (JSON webhook POST per alert) plus a
pluggable alert callback for custom receivers.
"""

from __future__ import annotations

import enum
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from cruise_control_tpu_torch.detector.anomalies import Anomaly, AnomalyType, BrokerFailures

LOG = logging.getLogger(__name__)

BROKER_FAILURE_ALERT_THRESHOLD_MS = 15 * 60 * 1000   # SelfHealingNotifier.java:67
BROKER_FAILURE_SELF_HEALING_THRESHOLD_MS = 30 * 60 * 1000  # :68


class AnomalyNotificationResult(enum.Enum):
    FIX = "fix"
    CHECK = "check"      # re-evaluate after delay_ms
    IGNORE = "ignore"


@dataclass
class NotificationAction:
    result: AnomalyNotificationResult
    delay_ms: float = 0.0


class NoopNotifier:
    def on_anomaly(self, anomaly: Anomaly) -> NotificationAction:
        return NotificationAction(AnomalyNotificationResult.IGNORE)

    def self_healing_enabled(self) -> Dict[AnomalyType, bool]:
        return {t: False for t in AnomalyType}

    def set_self_healing_for(self, anomaly_type: AnomalyType, enabled: bool) -> bool:
        return False


class SelfHealingNotifier:
    """Threshold-based self-healing policy (SelfHealingNotifier.java)."""

    def __init__(
        self,
        self_healing_enabled: bool = False,
        alert_callback: Optional[Callable[[Anomaly, bool], None]] = None,
        clock=lambda: time.time() * 1000,
        broker_failure_alert_threshold_ms: float = BROKER_FAILURE_ALERT_THRESHOLD_MS,
        broker_failure_self_healing_threshold_ms: float =
            BROKER_FAILURE_SELF_HEALING_THRESHOLD_MS,
    ):
        self._enabled: Dict[AnomalyType, bool] = {
            t: self_healing_enabled for t in AnomalyType}
        self._alert = alert_callback or (lambda anomaly, auto_fix: None)
        self._clock = clock
        self.alert_threshold_ms = broker_failure_alert_threshold_ms
        self.self_healing_threshold_ms = broker_failure_self_healing_threshold_ms
        self._alerted: Dict[int, bool] = {}

    # -------------------------------------------------------------- toggles

    def self_healing_enabled(self) -> Dict[AnomalyType, bool]:
        return dict(self._enabled)

    def set_self_healing_for(self, anomaly_type: AnomalyType, enabled: bool) -> bool:
        old = self._enabled.get(anomaly_type, False)
        self._enabled[anomaly_type] = enabled
        return old

    # --------------------------------------------------------------- policy

    def on_anomaly(self, anomaly: Anomaly) -> NotificationAction:
        if isinstance(anomaly, BrokerFailures):
            return self._on_broker_failure(anomaly)
        if not self._enabled.get(anomaly.anomaly_type, False):
            self._alert(anomaly, False)
            return NotificationAction(AnomalyNotificationResult.IGNORE)
        if not anomaly.fixable:
            self._alert(anomaly, False)
            return NotificationAction(AnomalyNotificationResult.IGNORE)
        return NotificationAction(AnomalyNotificationResult.FIX)

    def _on_broker_failure(self, anomaly: BrokerFailures) -> NotificationAction:
        """Grace-period logic (SelfHealingNotifier.java:106-148): alert after
        the alert threshold, auto-fix only after the self-healing threshold
        (measured from the EARLIEST broker failure)."""
        now = self._clock()
        if not anomaly.failed_brokers:
            return NotificationAction(AnomalyNotificationResult.IGNORE)
        earliest = min(anomaly.failed_brokers.values())
        alert_time = earliest + self.alert_threshold_ms
        fix_time = earliest + self.self_healing_threshold_ms
        if now < alert_time:
            return NotificationAction(AnomalyNotificationResult.CHECK,
                                      delay_ms=alert_time - now)
        auto_fix = self._enabled.get(AnomalyType.BROKER_FAILURE, False)
        if not self._alerted.get(anomaly.anomaly_id):
            self._alerted[anomaly.anomaly_id] = True
            self._alert(anomaly, auto_fix and now >= fix_time)
        if not auto_fix:
            return NotificationAction(AnomalyNotificationResult.IGNORE)
        if now < fix_time:
            return NotificationAction(AnomalyNotificationResult.CHECK,
                                      delay_ms=fix_time - now)
        return NotificationAction(AnomalyNotificationResult.FIX)


class WebhookSelfHealingNotifier(SelfHealingNotifier):
    """Webhook-alerting notifier (SlackSelfHealingNotifier.java:40-117 —
    POST a JSON message to a configured webhook URL per alert; Slack, MS
    Teams and generic receivers all accept this shape).

    Posts happen on the caller's thread with a short timeout and never raise:
    a broken webhook must not take down anomaly handling.
    """

    def __init__(self, webhook_url: str, channel: str = "",
                 sender: str = "cruise-control-tpu", timeout_s: float = 5.0,
                 post_fn=None, **kwargs):
        super().__init__(alert_callback=self._post_alert, **kwargs)
        self.webhook_url = webhook_url
        self.channel = channel
        self.sender = sender
        self.timeout_s = timeout_s
        self._post = post_fn or self._http_post

    def _http_post(self, payload: dict) -> None:
        import json as _json
        import urllib.request
        req = urllib.request.Request(
            self.webhook_url, data=_json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            resp.read()

    def _post_alert(self, anomaly: Anomaly, auto_fix_triggered: bool) -> None:
        payload = {
            "username": self.sender,
            "text": (f"{anomaly.anomaly_type.name} detected: {anomaly}. "
                     f"Self healing {'started' if auto_fix_triggered else 'not started'}."),
        }
        if self.channel:
            payload["channel"] = self.channel
        try:
            self._post(payload)
        except Exception:    # noqa: BLE001 — alerting must never break handling
            LOG.warning("webhook alert failed", exc_info=True)
