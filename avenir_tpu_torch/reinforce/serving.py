"""Online bandit serving loop (port of ``avenir_tpu/reinforce/serving.py``):
the Storm topology, in-process.

Parity target (SURVEY.md §2.6, §3.5): storm/ReinforcementLearnerTopology
.java:46-87 + ReinforcementLearnerBolt.java:97-135 — a spout feeding event
and reward messages from Redis queues into a bolt wrapping any factory
learner, actions written back to an action queue.

Two transports share the same message semantics:
  * in-process queue.Queue (ReinforcementLearnerService.start) — unit
    tests and single-process demos;
  * the wire (RedisServingLoop): Redis-list queues polled exactly like
    the reference spout (``rpop`` event/reward queues, actions
    ``lpush``ed — RedisSpout.java:83-95, RedisActionWriter.java:47-61),
    against the port's io/respq.RespServer or a real Redis, with the
    reference's
    config keys (redis.server.host/port, redis.event.queue,
    redis.reward.queue, redis.action.queue).

Message formats:
  event:  'round,<roundNum>'  -> respond with next_actions on action queue
  reward: 'reward,<action>,<value>' -> learner.set_reward
Processing is synchronous per message like the bolt's execute()."""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional, Sequence

import numpy as np

from .learners import create_learner


class ReinforcementLearnerService:
    def __init__(self, algorithm: str, actions: Sequence[str],
                 config: Optional[Dict] = None):
        self.learner = create_learner(algorithm, actions, config)
        self.event_queue: "queue.Queue[str]" = queue.Queue()
        self.action_queue: "queue.Queue[str]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.delim = ","

    # ---- the bolt's execute() (:97-135) ----
    def process(self, message: str) -> Optional[str]:
        parts = message.split(self.delim)
        if parts[0] == "round":
            actions = self.learner.next_actions()
            out = self.delim.join([parts[1]] + actions)
            self.action_queue.put(out)
            return out
        if parts[0] == "reward":
            self.learner.set_reward(parts[1], float(parts[2]))
            return None
        raise ValueError(f"unknown message type {parts[0]!r}")

    # ---- async loop (the topology submit) ----
    def start(self) -> None:
        def loop():
            while not self._stop.is_set():
                try:
                    msg = self.event_queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                self.process(msg)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


class VectorLearnerService:
    """Many-group real-time serving over the device-vectorized path: where
    the reference topology distributes one bolt per learner across Storm
    workers, one instance here serves EVERY group per round message with a
    single device selection (reinforce/batch.VectorBandits, all 11
    algorithms).  Action names map through ``actions`` like the scalar
    service.

    Messages:
      event:  'round,<roundNum>' -> one '<roundNum>,<group>,<action>' line
              per group on the action queue (returned joined by newlines)
      reward: 'reward,<groupIdx>,<action>,<value>'
    """

    def __init__(self, algorithm: str, actions: Sequence[str],
                 n_groups: int, config: Optional[Dict] = None,
                 seed: int = 0, device=None):
        from .batch import VectorBandits
        self.actions = list(actions)
        self.bandits = VectorBandits(algorithm, n_groups, len(self.actions),
                                     config, seed=seed, device=device)
        self.action_queue: "queue.Queue[str]" = queue.Queue()
        self.delim = ","

    def process(self, message: str) -> Optional[str]:
        parts = message.split(self.delim)
        if parts[0] == "round":
            acts = self.bandits.next_actions()
            lines = [self.delim.join([parts[1], str(g), self.actions[a]])
                     for g, a in enumerate(acts)]
            out = "\n".join(lines)
            for line in lines:
                self.action_queue.put(line)
            return out
        if parts[0] == "reward":
            g = np.array([int(parts[1])])
            a = np.array([self.actions.index(parts[2])])
            r = np.array([float(parts[3])], dtype=np.float32)
            self.bandits.set_rewards(g, a, r)
            return None
        raise ValueError(f"unknown message type {parts[0]!r}")


class RedisServingLoop:
    """The Storm topology over the wire: poll the event and reward queues
    (``rpop``, event queue first like RedisSpout.nextSpoutMessage), feed
    each message through the wrapped service's bolt-execute, and ``lpush``
    action responses — the reference's RedisSpout/RedisActionWriter
    contract against io/respq.RespServer or a real Redis.

    ``config`` uses the reference key names: redis.server.host,
    redis.server.port, redis.event.queue, redis.reward.queue,
    redis.action.queue.  A literal 'stop' message on the event queue ends
    :meth:`run` (transport-level control, not part of the bolt contract).

    The transport comes from :func:`io.respq.make_queue_client` — the
    same factory the serving fleet uses — so the loop inherits its
    config surface: ``redis.server.endpoints`` listing M shards drains
    through the consistent-hash ring, single host/port keeps the plain
    client, byte for byte the old behavior.
    """

    def __init__(self, service, config: Optional[Dict] = None):
        from ..io.respq import make_queue_client
        cfg = dict(config or {})
        self.service = service
        self.client = make_queue_client(cfg)
        self.event_q = cfg.get("redis.event.queue", "eventQueue")
        self.reward_q = cfg.get("redis.reward.queue", "rewardQueue")
        self.action_q = cfg.get("redis.action.queue", "actionQueue")
        self.stopped = False

    def poll_once(self) -> bool:
        """One spout pass; returns True if a message was processed."""
        msg = self.client.rpop(self.event_q)
        if msg is not None:
            if msg == "stop":
                # drain queued rewards first: the client pushes its final
                # rewards before 'stop', and dropping them would silently
                # lose learner updates on every shutdown
                while True:
                    r = self.client.rpop(self.reward_q)
                    if r is None:
                        break
                    self.service.process(r)
                self.stopped = True
                return True
            out = self.service.process(msg)
            if out is not None:
                self.client.lpush(self.action_q, out)
            return True
        msg = self.client.rpop(self.reward_q)
        if msg is not None:
            self.service.process(msg)
            return True
        return False

    def run(self, max_idle_s: float = 30.0, idle_sleep_s: float = 0.005
            ) -> None:
        """Poll until a 'stop' message or ``max_idle_s`` without traffic."""
        import time
        idle_since = time.monotonic()
        while not self.stopped:
            if self.poll_once():
                idle_since = time.monotonic()
            elif time.monotonic() - idle_since > max_idle_s:
                break
            else:
                time.sleep(idle_sleep_s)

    def close(self) -> None:
        self.client.close()
