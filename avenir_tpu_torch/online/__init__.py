"""The online learning plane: port of ``avenir_tpu/online``.  Serving and
learning in one dispatch a served window.

* :mod:`.state` — the learner state (bandit arm statistics, logistic
  weights, MLP parameters, the threaded key) and its byte round trip,
  the JAX package's format;
* :mod:`.plane` — the window pipeline (absorb -> learn -> predict, one
  dispatch at the ``online.window`` ledger site) and the pending-outcome
  table that joins ``reward,<id>,<value>`` messages to their decisions;
* :mod:`.service` — the wire tier: parses a drained window, runs it,
  answers, and feeds the supervisor.

The supervisor (snapshot cadence, accuracy-floor rollback) is
``control.controller.OnlineSupervisor``.
"""

from .plane import OnlineWindowPlane, PendingOutcomeTable  # noqa: F401
from .service import OnlineLearnerService  # noqa: F401
from .state import OnlineLearnerConfig, state_from_bytes, state_to_bytes  # noqa: F401
