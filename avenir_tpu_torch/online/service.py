"""The online learner's wire tier: port of ``avenir_tpu/online/service.py``.
One RESP stream, mixed verbs.

``predict,<id>,<f1>,...,<fN>`` rows are served; ``reward,<id>,<value>``
rows are joined to the decision ``<id>`` was answered with (the
native serving codec declines any batch holding the verb, so Python owns
reward parsing).

Reward acknowledgement is pinned to the snapshot cadence: a leased
reward message is acked only after a registry snapshot COVERING its
absorption commits, so a crash between absorb and snapshot redelivers
the reward instead of silently losing its effect (the chaos-drill
contract; without a supervisor, acks release at window end).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .plane import OnlineWindowPlane

REWARD_VERB = "reward"
STOP_VERB = "stop"


def reward_ack_token(rid: str, delim: str = ",") -> str:
    """The ack-queue value for a leased reward message: its lease id
    (``reward:<id>``, the broker's reward lease key) plus a marker
    field, so ``ackpush`` pops the lease without colliding with the
    prediction reply for the same request id."""
    return f"{REWARD_VERB}:{rid}{delim}acked"


class OnlineLearnerService:
    """Parse a drained window, run the fused program, answer.

    The service is transport-agnostic (the RESP loop below and the
    in-process benchmarks both feed :meth:`process_window`); it owns
    verb parsing, reply labels, the supervisor hand-off, and the
    held-until-snapshot reward-ack buffer.
    """

    def __init__(self, plane: OnlineWindowPlane, delim: str = ",",
                 counters=None, supervisor=None, name: str = "online"):
        from ..core.metrics import Counters
        self.plane = plane
        self.config = plane.config
        self.delim = delim
        self.counters = counters if counters is not None else Counters()
        self.supervisor = supervisor
        self.name = name
        self._held_acks: List[str] = []
        if supervisor is not None:
            supervisor.attach(plane)

    # ---- labels --------------------------------------------------------
    def decision_label(self, decision: Tuple[int, float, int]) -> str:
        arm, prob, cls = decision
        cfg = self.config
        if cfg.head == "logistic":
            return cfg.pos_label if prob >= cfg.threshold \
                else cfg.neg_label
        if cfg.head == "mlp":
            return cfg.mlp_label(cls)
        return cfg.actions[arm]

    def outcome_label(self, value: float) -> str:
        cfg = self.config
        if cfg.head == "mlp":
            return cfg.mlp_label(int(value))
        # logistic AND bandit: a positive outcome is the positive class
        # (for the bandit head this turns the accuracy floor into a
        # mean-reward floor — the regret guardrail, TPU_NOTES §31)
        return cfg.pos_label if value >= cfg.threshold else cfg.neg_label

    # ---- the window ----------------------------------------------------
    def process_window(self, messages: Sequence[str]
                       ) -> Tuple[List[str], List[str]]:
        """One served window: parse, dispatch once, answer.

        Returns ``(replies, ready_reward_acks)`` — replies are
        ``<id><delim><label>`` lines in request order; the ack tokens
        are the reward leases now safe to release (see module doc).
        """
        import time
        import warnings
        cfg = self.config
        d = self.delim
        t0 = time.perf_counter()
        requests: List[Tuple[str, np.ndarray]] = []
        rewards: List[Tuple[str, float]] = []
        new_acks: List[str] = []
        bad = 0
        for msg in messages:
            parts = msg.split(d)
            verb = parts[0]
            if verb == "predict" and len(parts) >= 2 and parts[1]:
                fields = parts[2:]
                if len(fields) != cfg.n_features:
                    bad += 1
                    continue
                try:
                    row = np.asarray([float(f) for f in fields],
                                     np.float32)
                except ValueError:
                    bad += 1
                    continue
                requests.append((parts[1], row))
            elif verb == REWARD_VERB:
                # reward,<id>,<value> — exactly three fields, finite
                # value; anything else is a bad request (and the near
                # miss family the wire fuzz pins)
                if len(parts) != 3 or not parts[1]:
                    bad += 1
                    continue
                try:
                    val = float(parts[2])
                except ValueError:
                    bad += 1
                    continue
                if not math.isfinite(val):
                    bad += 1
                    continue
                rewards.append((parts[1], val))
                new_acks.append(reward_ack_token(parts[1], d))
            elif verb == STOP_VERB:
                continue                  # the loop's token, not ours
            else:
                bad += 1
        if bad:
            self.counters.increment("Online", "BadRequests", bad)
            warnings.warn(f"online learner {self.name!r}: {bad} "
                          f"malformed message(s) dropped", RuntimeWarning)
        self.plane.note_parse(time.perf_counter() - t0)
        decisions: List[Tuple[str, int, float, int]] = []
        outcomes: List[Tuple[Tuple[int, float, int], float]] = []
        if requests or rewards:
            decisions, outcomes = self.plane.run_window(requests,
                                                        rewards)
        replies = [f"{rid}{d}{self.decision_label((arm, prob, cls))}"
                   for rid, arm, prob, cls in decisions]
        self.counters.increment("Online", "Windows", 1)
        self.counters.increment("Online", "Requests", len(requests))
        self.counters.increment("Online", "Rewards", len(rewards))
        self._held_acks.extend(new_acks)
        snapshot_committed = False
        if self.supervisor is not None:
            pred = [self.decision_label(dec) for dec, _ in outcomes]
            actual = [self.outcome_label(val) for _, val in outcomes]
            events = self.supervisor.on_window(pred, actual) or {}
            snapshot_committed = bool(events.get("snapshot"))
        ready: List[str] = []
        if self.supervisor is None or snapshot_committed:
            ready, self._held_acks = self._held_acks, []
        return replies, ready

    def flush_acks(self) -> List[str]:
        """Release every held reward ack (shutdown path: the final
        snapshot has been taken, or the caller accepts redelivery)."""
        ready, self._held_acks = self._held_acks, []
        return ready

    # ---- observability -------------------------------------------------
    def stats(self) -> dict:
        s = self.plane.run_stats()
        s["held_acks"] = len(self._held_acks)
        if self.supervisor is not None:
            s.update(self.supervisor.stats())
        return s

    def export(self, counters=None) -> None:
        c = counters if counters is not None else self.counters
        self.plane.export(c)
        for k, v in self.plane.pending.stats().items():
            c.set("Online", k.capitalize(), v)

    def bind_metrics(self, registry) -> None:
        """``avenir_online_*`` gauges over the live service (the §21
        registry probe discipline: refreshed per scrape)."""
        g = registry.gauge(
            "avenir_online_state",
            "online learning plane state (windows, pending joins, "
            "reward accounting, supervisor counts)",
            labels=("learner", "key"))

        def probe():
            for k, v in self.stats().items():
                g.set(v, learner=self.name, key=k)
        registry.register_probe(probe)


class OnlineRespLoop:
    """Drain one RESP stream of mixed predict/reward traffic through
    the service: leased delivery in, ``ackpush`` replies out (reply +
    predict-lease ack in one trip), reward acks released on the
    snapshot cadence.  A worker killed mid-window never acked — its
    whole window redelivers after the lease expires."""

    def __init__(self, service: OnlineLearnerService, client,
                 request_queue: str = "requestQueue",
                 reply_queue: str = "predictionQueue",
                 reward_ack_queue: str = "rewardAckQueue",
                 batch: int = 64, lease_s: float = 30.0,
                 block_s: float = 0.05):
        self.service = service
        self.client = client
        self.request_queue = request_queue
        self.reply_queue = reply_queue
        self.reward_ack_queue = reward_ack_queue
        self.batch = int(batch)
        self.lease_s = float(lease_s)
        self.block_s = float(block_s)

    def run(self, max_windows: Optional[int] = None) -> int:
        windows = 0
        while max_windows is None or windows < max_windows:
            msgs = self.client.lease_many(self.request_queue, self.batch,
                                          self.lease_s,
                                          block_s=self.block_s)
            if not msgs:
                if max_windows is None:
                    break
                continue
            stop = STOP_VERB in msgs
            msgs = [m for m in msgs if m != STOP_VERB]
            if msgs:
                replies, acks = self.service.process_window(msgs)
                if replies:
                    self.client.ackpush(self.reply_queue,
                                        self.request_queue, replies)
                if acks:
                    self.client.ackpush(self.reward_ack_queue,
                                        self.request_queue, acks)
                windows += 1
            if stop:
                final = self.service.flush_acks()
                if final:
                    self.client.ackpush(self.reward_ack_queue,
                                        self.request_queue, final)
                break
        return windows
