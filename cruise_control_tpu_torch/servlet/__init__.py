"""API layer: REST endpoints, async user tasks, two-step verification.

Reference: ``servlet/KafkaCruiseControlServlet.java`` + the 20-endpoint enum
(``servlet/CruiseControlEndPoint.java:17-36``), ``servlet/UserTaskManager``
async machinery, and ``servlet/purgatory`` two-step review.
"""

from cruise_control_tpu_torch.servlet.user_tasks import UserTaskManager, TaskState
from cruise_control_tpu_torch.servlet.server import CruiseControlApp

__all__ = ["UserTaskManager", "TaskState", "CruiseControlApp"]
