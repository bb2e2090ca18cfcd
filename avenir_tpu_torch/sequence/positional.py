"""Event-locality clustering inside sliding time windows: the port of
``avenir_tpu/sequence/positional.py`` (host code, copied).

Parity target: SequencePositionalCluster — a map-only pass feeding each
(timestamp, quantity) record into a time-bound window analyzer (hoidla's
``TimeBoundEventLocalityAnalyzer``) and emitting ``seqNum,quant,score``
whenever the locality score beats the threshold.  hoidla is not vendored
in the reference, so the JAX package re-specified the analyzer:

  * a sliding window keeps events no older than ``window_time_span``
  * events arriving closer than ``min_event_time_interval`` after the
    previous accepted event are debounced (ignored)
  * the score is recomputed when at least ``time_step`` has elapsed since
    the previous scoring (between scorings the last score holds)
  * locality strategies over the CONDITION-MATCHED events in the window:
      count            #matched >= min_occurence
      averageInterval  mean successive gap <= max_interval_average
      maxInterval      max successive gap  <= max_interval_max
      rangeLength      last - first        >= min_range_length
  * plain mode: score = 1.0 if ANY (any_cond) / ALL strategies pass else 0.0
  * weighted mode: score = sum of weight * soft score per strategy, where
    the soft scores are window-normalized locality measures in [0, 1]:
      count            matched / (span / min_event_time_interval)
      averageInterval  1 - meanGap / span
      maxInterval      1 - maxGap / span
      rangeLength      range / span
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field as dc_field
from typing import Deque, Dict, List, Optional, Sequence, Tuple


@dataclass
class LocalityConfig:
    window_time_span: int
    time_step: int
    min_event_time_interval: int = 100
    weighted: bool = False
    weighted_strategies: Dict[str, float] = dc_field(default_factory=dict)
    preferred_strategies: Sequence[str] = ("count",)
    any_cond: bool = True
    min_occurence: int = 2
    max_interval_average: float = 0.0
    max_interval_max: float = 0.0
    min_range_length: float = 0.0


class TimeBoundEventLocalityAnalyzer:
    """Streaming window analyzer (hoidla-equivalent, see module doc)."""

    def __init__(self, config: LocalityConfig):
        self.cfg = config
        self._events: Deque[Tuple[int, bool]] = deque()
        self._last_accepted: Optional[int] = None
        self._last_scored: Optional[int] = None
        self._score = 0.0

    def add(self, timestamp: int, condition_met: bool) -> None:
        c = self.cfg
        if (self._last_accepted is not None and
                timestamp - self._last_accepted < c.min_event_time_interval):
            return
        self._last_accepted = timestamp
        self._events.append((timestamp, condition_met))
        cutoff = timestamp - c.window_time_span
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()
        if (self._last_scored is None or
                timestamp - self._last_scored >= c.time_step):
            self._score = self._compute_score()
            self._last_scored = timestamp

    @property
    def score(self) -> float:
        return self._score

    def _matched(self) -> List[int]:
        return [t for t, m in self._events if m]

    def _strategy_scores(self, ts: List[int]) -> Dict[str, float]:
        c = self.cfg
        span = float(c.window_time_span)
        gaps = [b - a for a, b in zip(ts, ts[1:])]
        rng = float(ts[-1] - ts[0]) if len(ts) >= 2 else 0.0
        mean_gap = sum(gaps) / len(gaps) if gaps else span
        max_gap = max(gaps) if gaps else span
        cap = max(span / c.min_event_time_interval, 1.0)
        return {
            "count": min(len(ts) / cap, 1.0),
            "averageInterval": max(0.0, 1.0 - mean_gap / span),
            "maxInterval": max(0.0, 1.0 - max_gap / span),
            "rangeLength": min(rng / span, 1.0),
        }

    def _strategy_passes(self, ts: List[int]) -> Dict[str, bool]:
        c = self.cfg
        gaps = [b - a for a, b in zip(ts, ts[1:])]
        return {
            "count": len(ts) >= c.min_occurence,
            "averageInterval": bool(gaps) and
            (sum(gaps) / len(gaps)) <= c.max_interval_average,
            "maxInterval": bool(gaps) and max(gaps) <= c.max_interval_max,
            "rangeLength": len(ts) >= 2 and
            (ts[-1] - ts[0]) >= c.min_range_length,
        }

    def _compute_score(self) -> float:
        ts = self._matched()
        if not ts:
            return 0.0
        if self.cfg.weighted:
            soft = self._strategy_scores(ts)
            return sum(w * soft.get(name, 0.0)
                       for name, w in self.cfg.weighted_strategies.items())
        passes = self._strategy_passes(ts)
        flags = [passes.get(name, False)
                 for name in self.cfg.preferred_strategies]
        ok = any(flags) if self.cfg.any_cond else all(flags)
        return 1.0 if ok else 0.0


def positional_cluster(records: Sequence[Tuple[int, float]],
                       config: LocalityConfig,
                       score_threshold: float,
                       condition_flags: Optional[Sequence[bool]] = None
                       ) -> List[Tuple[int, float, float]]:
    """Stream records (timestamp, quantity) through the analyzer; returns
    (timestamp, quantity, score) for every record whose score strictly
    beats the threshold.  ``condition_flags`` marks the records that meet
    the condition (the job evaluates its cond.expression over the full
    row); without it every record does."""
    analyzer = TimeBoundEventLocalityAnalyzer(config)
    out = []
    for i, (ts, quant) in enumerate(records):
        met = True if condition_flags is None else bool(condition_flags[i])
        analyzer.add(ts, met)
        if analyzer.score > score_threshold:
            out.append((ts, quant, analyzer.score))
    return out
