"""Two-step verification purgatory.

Reference: ``servlet/purgatory/Purgatory.java:1-280`` + ``ReviewBoard`` —
when two-step verification is enabled, mutating POST requests park here with
a review id until an admin approves (``REVIEW`` endpoint), then execute by
submitting the approved request.
"""

from __future__ import annotations

import enum
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class ReviewStatus(enum.Enum):
    PENDING_REVIEW = "PENDING_REVIEW"
    APPROVED = "APPROVED"
    SUBMITTED = "SUBMITTED"
    DISCARDED = "DISCARDED"


_ids = itertools.count()


@dataclass
class RequestInfo:
    review_id: int
    endpoint: str
    query: str
    submitter: str
    status: ReviewStatus = ReviewStatus.PENDING_REVIEW
    reason: str = ""
    submitted_ms: float = field(default_factory=lambda: time.time() * 1000)

    def to_dict(self) -> Dict:
        return {"Id": self.review_id, "EndPoint": self.endpoint,
                "Query": self.query, "Submitter": self.submitter,
                "Status": self.status.value, "Reason": self.reason}


class Purgatory:
    def __init__(self, retention_ms: float = 86_400_000):
        self._requests: Dict[int, RequestInfo] = {}
        self._lock = threading.Lock()
        self.retention_ms = retention_ms

    def add(self, endpoint: str, query: str, submitter: str = "") -> RequestInfo:
        with self._lock:
            info = RequestInfo(next(_ids), endpoint, query, submitter)
            self._requests[info.review_id] = info
            return info

    def review(self, review_id: int, approve: bool, reason: str = "") -> RequestInfo:
        with self._lock:
            info = self._requests[review_id]
            if info.status is not ReviewStatus.PENDING_REVIEW:
                raise ValueError(f"request {review_id} is {info.status.value}")
            info.status = (ReviewStatus.APPROVED if approve
                           else ReviewStatus.DISCARDED)
            info.reason = reason
            return info

    def take_approved(self, review_id: int) -> RequestInfo:
        """Mark an approved request as submitted and return it for execution."""
        with self._lock:
            info = self._requests[review_id]
            if info.status is not ReviewStatus.APPROVED:
                raise ValueError(
                    f"request {review_id} is {info.status.value}, not APPROVED")
            info.status = ReviewStatus.SUBMITTED
            return info

    def board(self) -> List[Dict]:
        with self._lock:
            now = time.time() * 1000
            for rid, info in list(self._requests.items()):
                if (info.status in (ReviewStatus.SUBMITTED, ReviewStatus.DISCARDED)
                        and now - info.submitted_ms > self.retention_ms):
                    del self._requests[rid]
            return [i.to_dict() for i in self._requests.values()]
