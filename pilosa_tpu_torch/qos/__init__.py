"""Request-lifecycle QoS: deadlines, admission control, overload shedding.

No reference analog — handler.go serves every request it can accept()
and has no notion of a deadline or a full queue.  The north star
(heavy traffic from millions of users) needs the serving stack to
survive SATURATION: a request carries a deadline end to end (HTTP
header -> executor checkpoints -> cluster fan-out -> lockstep batch
entries), and every serving path has a bounded door — when the bound is
hit the request is rejected immediately (429 + Retry-After) instead of
queuing into collapse.

Pieces:

- :mod:`pilosa_tpu_torch.qos.deadline` — ``Deadline`` (monotonic budget,
  header wire format) and ``DeadlineExceeded`` (HTTP 504);
- :mod:`pilosa_tpu_torch.qos.admission` — request classes (read / write /
  admin), the per-class bounded admission gate, and ``ShedError``
  (HTTP 429/503 + Retry-After).
"""

from pilosa_tpu_torch.qos.admission import (
    CLASS_ADMIN,
    CLASS_READ,
    CLASS_WRITE,
    AdmissionController,
    ShedError,
    classify_request,
)
from pilosa_tpu_torch.qos.deadline import (
    DEADLINE_HEADER,
    Deadline,
    DeadlineExceeded,
    deadline_from_headers,
)

__all__ = [
    "AdmissionController",
    "CLASS_ADMIN",
    "CLASS_READ",
    "CLASS_WRITE",
    "DEADLINE_HEADER",
    "Deadline",
    "DeadlineExceeded",
    "ShedError",
    "classify_request",
    "deadline_from_headers",
]
