"""SLO-driven fleet autoscaler: port of ``avenir_tpu/serving/
autoscaler.py``.

The data plane — :class:`~avenir_tpu_torch.serving.fleet.ServingFleet`
workers with their warm bucketed predictors — keeps all device state; this
module is the thin control plane that only repoints traffic, by starting
and parking workers through ``ServingFleet.scale_to``.

Three pieces, each testable alone:

  * **sensor** (:meth:`FleetAutoscaler._sense`) — every tick: the broker
    queue depth (``llen`` over the shard ring, no popping) plus the
    requests already pulled into worker queues, its derivative over the
    tick interval, and the fleet's recent request p99 from the workers'
    ``StepTimer`` windows (the windows the ``/metrics`` gauges render).
  * **policy** (:class:`AutoscalePolicy` + :meth:`FleetAutoscaler.decide`)
    — pure: (depth, derivative, p99, active) -> ``"up" | "down" |
    "hold"``, with hysteresis on three axes so the loop never flaps:
    distinct pressure and calm bands, consecutive-tick debounce, and a
    post-action cooldown.  Pressure scales up fast, calm scales down
    slowly.
  * **actuator** — ``fleet.scale_to(active ± 1)``: unpark-first warm
    scale-up, park-the-tail scale-down, never below ``min_workers``.

Every decision, holds included, is a traced instant
(``autoscaler.decision``) and a tally under ``Autoscaler/*``.
"""

from __future__ import annotations

import itertools
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..telemetry import instant


@dataclass
class AutoscalePolicy:
    """The policy knobs.  Defaults suit sub-second ticks and
    single-digit worker counts; the hysteresis
    SHAPE, not the exact numbers, is the contract.

    Pressure (any one axis): queue depth ≥ ``depth_high``; depth rising
    faster than ``derivative_high``/s while non-trivial; or — with an
    SLO budget set — recent p99 ≥ ``p99_high_fraction`` of it.

    Calm (ALL axes): depth ≤ ``depth_low``, derivative ≤ 0, and p99 ≤
    ``p99_low_fraction`` of the budget (p99 always passes with no SLO
    set).  Between the bands: hold."""
    min_workers: int = 1
    max_workers: int = 4
    slo_p99_ms: float = 0.0          # 0 = depth/derivative-only policy
    depth_high: int = 64             # queued requests = real backlog
    depth_low: int = 4               # near-drained
    derivative_high: float = 50.0    # req/s of queue GROWTH = a spike
    p99_high_fraction: float = 0.8   # p99 at 80% of budget = pressure
    p99_low_fraction: float = 0.5    # p99 under half budget = calm
    up_consecutive: int = 2          # ticks of pressure before +1
    down_consecutive: int = 6        # ticks of calm before -1 (slower)
    cooldown_ticks: int = 3          # no action this soon after one

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError(f"min_workers must be >= 1, got "
                             f"{self.min_workers}")
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers ({self.max_workers}) < min_workers "
                f"({self.min_workers})")
        if self.depth_low >= self.depth_high:
            raise ValueError(
                f"hysteresis band inverted: depth_low "
                f"({self.depth_low}) must sit under depth_high "
                f"({self.depth_high})")
        if self.slo_p99_ms and not (0.0 < self.p99_low_fraction
                                    < self.p99_high_fraction <= 1.0):
            raise ValueError(
                f"p99 fractions must satisfy 0 < low < high <= 1, got "
                f"low={self.p99_low_fraction} "
                f"high={self.p99_high_fraction}")


class FleetAutoscaler:
    """Sensor→policy→actuator loop over one :class:`ServingFleet`.

    ``broker`` is anything with ``llen(queue)`` (a :class:`RespClient`
    or :class:`ShardedRespClient` — the sharded form sums the ring);
    ``depth_fn``/``p99_fn`` override the sensors outright (unit tests
    drive :meth:`tick` with synthetic traffic; production leaves them
    None).  ``start()`` runs :meth:`tick` every ``interval_s`` on a
    daemon thread; a failing tick warns and keeps ticking — a flaky
    scrape must not kill the control loop (and with it the scale-down
    path, pinning the fleet at peak footprint forever)."""

    # how many of the newest serve.request samples per worker feed the
    # p99 sensor — same recency rationale as PredictionService's
    # adaptive-window _ADAPT_SAMPLES
    _P99_SAMPLES = 256

    def __init__(self, fleet, broker=None, *,
                 queue: Optional[str] = None,
                 policy: Optional[AutoscalePolicy] = None,
                 interval_s: float = 0.25,
                 counters=None,
                 depth_fn=None, p99_fn=None):
        self.fleet = fleet
        self.broker = broker
        self.queue = queue if queue is not None \
            else getattr(fleet, "request_q", "requestQueue")
        self.policy = policy or AutoscalePolicy()
        self.interval_s = float(interval_s)
        self.counters = counters
        self._depth_fn = depth_fn
        self._p99_fn = p99_fn
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # controller state: the hysteresis memory
        self._pressure_ticks = 0
        self._calm_ticks = 0
        self._cooldown = 0
        self._last_depth: Optional[int] = None
        self._last_t: Optional[float] = None
        # per-worker serve.request call totals at the last tick: the
        # staleness detector for the p99 sensor (see _sense_p99_ms)
        self._last_calls: Dict[str, int] = {}
        self.decisions: List[Dict] = []   # bounded in tick()
        self._count("Ticks", 0)   # group visible from tick zero

    # ---- counters ----
    def _count(self, name: str, n: int = 1) -> None:
        if self.counters is not None:
            self.counters.increment("Autoscaler", name, n)

    # ---- sensor ----
    def _sense_depth(self) -> int:
        if self._depth_fn is not None:
            return int(self._depth_fn())
        depth = 0
        if self.broker is not None:
            depth += int(self.broker.llen(self.queue))
        # requests already pulled off the broker but still coalescing
        # inside worker queues are backlog too — without them a fleet
        # that drains the broker into deep service queues reads "calm"
        # while requests age
        for w in list(self.fleet.workers):
            depth += w.service.stats()["queue_depth"]
        return depth

    def _sense_p99_ms(self) -> float:
        if self._p99_fn is not None:
            return float(self._p99_fn())
        recent: List[float] = []
        fresh = False
        for w in list(self.fleet.workers):
            # staleness guard: the sample window remembers the last N
            # requests FOREVER — after a spike drains and traffic goes
            # quiet, those samples would read as permanent pressure and
            # pin the fleet at peak footprint.  No new serve.request
            # completions anywhere since the last tick = no live
            # latency = no pressure.
            calls = w.service.timer.calls.get("serve.request", 0)
            if calls != self._last_calls.get(w.name, 0):
                fresh = True
            self._last_calls[w.name] = calls
            s = w.service.timer.samples.get("serve.request")
            if not s:
                continue
            for _ in range(3):   # deque may be appended to concurrently
                try:
                    # newest N via reversed islice — copying the whole
                    # 8k-sample deque per worker per tick to keep 256
                    # would be real steady-state overhead on the very
                    # host serving the traffic (order is irrelevant to
                    # the percentile)
                    recent.extend(itertools.islice(
                        reversed(s), self._P99_SAMPLES))
                    break
                except RuntimeError:
                    continue
        if not recent or not fresh:
            return 0.0
        return float(np.percentile(np.asarray(recent), 99)) * 1000.0

    def _sense_model_depths(self) -> Dict[str, int]:
        # per-tenant pressure: a models= fleet exposes
        # model_queue_depths() — each resident model's own queued
        # backlog, summed across workers.  The aggregate policy still
        # decides up/down; the per-model split rides every decision
        # record and instant so an operator can see WHICH tenant's
        # backlog drove the action.
        probe = getattr(self.fleet, "model_queue_depths", None)
        if probe is None:
            return {}
        try:
            return dict(probe())
        except Exception:
            return {}

    def _sense(self) -> Dict:
        now = time.monotonic()
        depth = self._sense_depth()
        if self._last_depth is None or self._last_t is None \
                or now <= self._last_t:
            deriv = 0.0
        else:
            deriv = (depth - self._last_depth) / (now - self._last_t)
        self._last_depth, self._last_t = depth, now
        sensed = {"depth": depth, "derivative_per_s": round(deriv, 2),
                  "p99_ms": round(self._sense_p99_ms(), 3)}
        by_model = self._sense_model_depths()
        if by_model:
            sensed["depth_by_model"] = by_model
        return sensed

    # ---- policy (pure: no clocks, no actuation) ----
    def decide(self, depth: int, deriv: float, p99_ms: float,
               active: int) -> str:
        """One policy step over one sensed sample; mutates only the
        hysteresis counters.  Returns ``"up" | "down" | "hold"`` — the
        caller actuates."""
        pol = self.policy
        pressure = depth >= pol.depth_high \
            or (deriv >= pol.derivative_high and depth > pol.depth_low) \
            or (pol.slo_p99_ms > 0
                and p99_ms >= pol.p99_high_fraction * pol.slo_p99_ms)
        calm = depth <= pol.depth_low and deriv <= 0.0 \
            and (pol.slo_p99_ms <= 0
                 or p99_ms <= pol.p99_low_fraction * pol.slo_p99_ms)
        if pressure:
            self._pressure_ticks += 1
            self._calm_ticks = 0
        elif calm:
            self._calm_ticks += 1
            self._pressure_ticks = 0
        else:
            # between the bands: hysteresis hold — decay both memories
            # so a long ambiguous spell cannot bank ticks toward either
            # action
            self._pressure_ticks = 0
            self._calm_ticks = 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return "hold"
        if pressure and self._pressure_ticks >= pol.up_consecutive \
                and active < pol.max_workers:
            self._pressure_ticks = 0
            self._cooldown = pol.cooldown_ticks
            return "up"
        if calm and self._calm_ticks >= pol.down_consecutive \
                and active > pol.min_workers:
            self._calm_ticks = 0
            self._cooldown = pol.cooldown_ticks
            return "down"
        return "hold"

    # ---- one full sensor→policy→actuator pass ----
    def tick(self) -> Dict:
        """Sense, decide, actuate, emit.  Returns the decision record
        (also appended to :attr:`decisions`, bounded to the last 4096,
        and emitted as an ``autoscaler.decision`` trace instant)."""
        sensed = self._sense()
        active = self.fleet.active_workers()
        if active < self.policy.min_workers:
            # the floor is the actuator's job, not the pressure rule's:
            # a fleet started (or externally scaled) below min_workers
            # must be brought up even under perfect calm — decide()
            # only ever scales up on pressure
            action = "up"
        else:
            action = self.decide(sensed["depth"],
                                 sensed["derivative_per_s"],
                                 sensed["p99_ms"], active)
        new_active = active
        if action == "up":
            new_active = self.fleet.scale_to(
                max(active + 1, self.policy.min_workers))
            self._count("ScaleUps")
        elif action == "down":
            new_active = self.fleet.scale_to(active - 1)
            self._count("ScaleDowns")
        else:
            self._count("Holds")
        self._count("Ticks")
        if self.counters is not None:
            self.counters.set("Autoscaler", "ActiveWorkers", new_active)
        rec = {"action": action, "active": active,
               "new_active": new_active, **sensed,
               "slo_p99_ms": self.policy.slo_p99_ms,
               "pressure_ticks": self._pressure_ticks,
               "calm_ticks": self._calm_ticks,
               "cooldown": self._cooldown}
        # the host label rides the instant (not the decision record) so
        # a multi-host incident report can attribute scale actions
        instant("autoscaler.decision", cat="serving",
                host=getattr(self.fleet, "host_label", None), **rec)
        self.decisions.append(rec)
        if len(self.decisions) > 4096:
            del self.decisions[:2048]
        return rec

    # ---- lifecycle ----
    def start(self) -> "FleetAutoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception as exc:
                    # the control loop must outlive a flaky scrape: a
                    # dead autoscaler after a spike would pin the fleet
                    # at max footprint forever
                    warnings.warn(
                        f"autoscaler tick failed ({type(exc).__name__}: "
                        f"{exc}); continuing", RuntimeWarning)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="avenir-autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=max(5.0, 4 * self.interval_s))
        self._thread = None
