"""Per-request distributed trace context for the serving path: port of
``avenir_tpu/telemetry/reqtrace.py``.

The serving wire protocol grows ONE optional, backward-compatible field:

    predict,<id>,t=<enqueue_us>:<sampled>,<field0>,<field1>,...

Absent field = old behavior, byte for byte.  The field is stamped
head-based on the CLIENT (``RespClient`` at push time):
``set_sample_rate(N)`` — the ``ps.trace.sample`` config key, env twin
``AVENIR_TPU_TRACE_SAMPLE`` — samples every Nth predict message, so with
sampling off (the default 0) the whole module is one global read
per push batch and the wire bytes are unchanged.  Consumers
(``RespPredictionLoop``, ``PredictionService.process_batch``)
parse the field whether or not THEIR process samples: tracing is decided
at the head, everyone downstream just carries the context.

A sampled request travels as a :class:`RequestTrace` and leaves:

  * one Chrome legacy **flow** per hop — all legs named ``request``
    (catapult binds flow arrows on the cat+name+id triplet, so the hop
    label rides in ``args.step``): ``s`` at client enqueue (with the
    owning broker shard), ``t`` at worker pop and device dispatch,
    ``f`` at reply push — the one-arrow-per-request view across process
    lanes in the merged timeline;
  * **component timings** — queue_wait (enqueue->pop), coalesce
    (pop->dispatch), device (dispatch->readback), reply
    (readback->reply push) — derived purely from timestamps the loops
    already take (no new syncs), summing EXACTLY to reply-enqueue by
    construction, carried on the flow's ``f`` finish.

Timestamps are epoch microseconds on the installed tracer's
epoch-anchored clock (``time.time()`` when no tracer is installed), the
same clock the span events use.  The component SUM always telescopes to
reply-enqueue exactly; within it, ``coalesce``/``device``/``reply``
pair stamps one process took, while ``queue_wait`` (and therefore
``total``) bridge the client→worker clock boundary and absorb whatever
skew exists there (same-machine: ~ms).  Flow ids are namespaced
``<run_id>:<request_id>`` so two runs (or a resumed attempt) sharing one trace dir never collide.
"""

from __future__ import annotations

import itertools
import os
import re
import time
from typing import List, Optional, Sequence, Tuple

from .trace import current_tracer, flow

TRACE_FIELD_PREFIX = "t="
SAMPLE_ENV = "AVENIR_TPU_TRACE_SAMPLE"
FLOW_NAME = "request"
FLOW_CAT = "request"
COMPONENTS = ("queue_wait", "coalesce", "device", "reply")

_sample_n = 0
# racy-by-design modulo counters: head sampling is statistical, and a
# lost increment under thread races only perturbs WHICH request is the
# Nth — never correctness.  itertools.count increments in C.
_counter = itertools.count(1)
_local_ids = itertools.count(1)


def set_sample_rate(n) -> int:
    """Sample every Nth predict push (0 = off, the default)."""
    global _sample_n
    _sample_n = max(0, int(n or 0))
    return _sample_n


def reset_sampling() -> None:
    """Restart the head-sampling counter, so the next predict push is the
    first one counted (``set_sample_rate`` keeps the count running)."""
    global _counter
    _counter = itertools.count(1)


def sample_rate() -> int:
    return _sample_n


def enabled() -> bool:
    return _sample_n > 0


def configure_from_env() -> int:
    """Honor the ``AVENIR_TPU_TRACE_SAMPLE`` env twin (ignored when
    unparseable — a bad env var must not abort serving)."""
    raw = os.environ.get(SAMPLE_ENV)
    if raw:
        try:
            return set_sample_rate(int(raw))
        except ValueError:
            pass
    return _sample_n


def now_us() -> float:
    """Epoch microseconds on the installed tracer's epoch-anchored
    clock, so request stamps and span events share one timeline."""
    tr = current_tracer()
    if tr is not None:
        return tr.now_us()
    return time.time() * 1e6


def flow_id_of(rid: str) -> str:
    """The namespaced flow id for a request: ``<run_id>:<rid>`` under an
    installed tracer, the bare rid otherwise.  Every process of one run
    shares the run id by contract, so all legs of one request's flow still bind
    — while a SECOND run (or a resumed attempt appending into the same
    trace dir) can never collide ids with the first.  Request ids must
    not contain ``:`` (the wire delimiter is ``,``; row indexes and
    uuids are fine)."""
    tr = current_tracer()
    if tr is not None:
        return f"{tr.run_id}:{rid}"
    return str(rid)


def emit_flow(phase: str, rid: str, step: str,
              ts_us: Optional[float] = None, **args) -> None:
    """THE flow-emission funnel: every request-flow leg goes through
    here so the name/cat/id-namespacing contract lives in one place.
    Returns before any id/args formatting when no tracer is installed —
    this runs per sampled request on the serving hot path."""
    if current_tracer() is None:
        return
    flow(FLOW_NAME, phase, flow_id_of(rid), cat=FLOW_CAT, ts_us=ts_us,
         step=step, **args)


class RequestTrace:
    """One sampled request's context: identity + the hop timestamps the
    serving loops fill in as it moves.  ``wire`` marks a context that
    entered over the wire (its ``f`` finish belongs to the reply PUSH,
    emitted by the fleet flush / wire loop, not the in-process reply)."""

    __slots__ = ("rid", "enqueue_us", "wire", "t_pop_us",
                 "t_dispatch_us", "t_done_us", "t_reply_us")

    def __init__(self, rid: str, enqueue_us: float, wire: bool = False):
        self.rid = str(rid)
        self.enqueue_us = float(enqueue_us)
        self.wire = wire
        self.t_pop_us: Optional[float] = None
        self.t_dispatch_us: Optional[float] = None
        self.t_done_us: Optional[float] = None
        self.t_reply_us: Optional[float] = None

    def components_ms(self) -> dict:
        """The latency decomposition.  Missing stamps degrade to the
        previous hop (a busy-rejected request never dispatched: its
        coalesce/device read 0), so the sum ALWAYS telescopes to
        ``total`` = reply - enqueue."""
        enq = self.enqueue_us
        pop = self.t_pop_us if self.t_pop_us is not None else enq
        disp = self.t_dispatch_us if self.t_dispatch_us is not None \
            else pop
        done = self.t_done_us if self.t_done_us is not None else disp
        reply = self.t_reply_us if self.t_reply_us is not None else done
        return {
            "queue_wait": (pop - enq) / 1e3,
            "coalesce": (disp - pop) / 1e3,
            "device": (done - disp) / 1e3,
            "reply": (reply - done) / 1e3,
            "total": (reply - enq) / 1e3,
        }


# --------------------------------------------------------------------------
# wire field
# --------------------------------------------------------------------------

def encode_field(enqueue_us: float, sampled: int = 1) -> str:
    return f"{TRACE_FIELD_PREFIX}{int(enqueue_us)}:{1 if sampled else 0}"


# the EXACT grammar the backward-compat rule promises:
# strip only `t=<int>:<0|1>`.  Anything laxer would eat a legitimate
# old-format feature that merely starts with "t=" — and fabricate a
# sampled context from it with tracing off.
_FIELD_RE = re.compile(r"^t=(\d+):([01])$")


def parse_field(tok: str) -> Optional[Tuple[float, bool]]:
    """``(enqueue_us, sampled)`` for a trace-field token, None when the
    token is not one (it is then an ordinary feature value — the
    backward-compatibility rule: only ``t=<int>:<0|1>`` parses)."""
    m = _FIELD_RE.match(tok)
    if m is None:
        return None
    return float(m.group(1)), m.group(2) == "1"


DEADLINE_FIELD_PREFIX = "d="

# same backward-compat rule as the trace field:
# only `d=<int>` is a deadline; anything laxer would eat a legitimate
# feature value that merely starts with "d=".
_DEADLINE_RE = re.compile(r"^d=(\d+)$")


def encode_deadline(deadline_us: float) -> str:
    return f"{DEADLINE_FIELD_PREFIX}{int(deadline_us)}"


def parse_deadline(tok: str) -> Optional[float]:
    """Absolute epoch-microsecond deadline for a deadline-field token,
    None when the token is not one (ordinary feature value)."""
    m = _DEADLINE_RE.match(tok)
    if m is None:
        return None
    return float(m.group(1))


MODEL_FIELD_PREFIX = "m="

# same backward-compat rule again: only
# `m=<name>` or `m=<name>:<version>` routes, where <name> is
# [A-Za-z0-9_.-]+ (registry model names) and <version> is digits.
# Anything laxer would eat a legitimate feature value starting "m=".
_MODEL_RE = re.compile(r"^m=([A-Za-z0-9_.\-]+)(?::(\d+))?$")


def encode_model(name: str, version: Optional[int] = None) -> str:
    if version is None:
        return f"{MODEL_FIELD_PREFIX}{name}"
    return f"{MODEL_FIELD_PREFIX}{name}:{int(version)}"


def parse_model(tok: str) -> Optional[Tuple[str, Optional[int]]]:
    """``(model_name, version_or_None)`` for a model-routing token, None
    when the token is not one (ordinary feature value — only
    ``m=<name>[:<version>]`` routes)."""
    m = _MODEL_RE.match(tok)
    if m is None:
        return None
    v = m.group(2)
    return m.group(1), (int(v) if v is not None else None)


def split_predict_route(parts: Sequence[str]):
    """Consumer-side parse of an already-split predict message:
    ``(request_id, row_fields, ctx_or_None, deadline_us_or_None,
    model_tag_or_None)``.

    The optional fields ride in order after the id — ``t=...`` then
    ``d=...`` then ``m=...``, each independently absent — and each is
    recognized only when at least one token follows it (a row must
    remain).  The deadline is absolute epoch microseconds on
    the :func:`now_us` clock: consumers answer ``<id>,late`` without a
    device dispatch once it has passed.  The model tag is
    ``(name, version_or_None)``: a multi-model router dispatches to that
    resident model; a single-model service strips it and serves its own
    model (the tag is advisory, never a feature value)."""
    rid = parts[1]
    i = 2
    ctx = None
    deadline = None
    model_tag = None
    if len(parts) >= i + 2 and parts[i].startswith(TRACE_FIELD_PREFIX):
        parsed = parse_field(parts[i])
        if parsed is not None:
            enqueue_us, sampled = parsed
            if sampled:
                ctx = RequestTrace(rid, enqueue_us, wire=True)
            i += 1
    if len(parts) >= i + 2 and parts[i].startswith(DEADLINE_FIELD_PREFIX):
        d = parse_deadline(parts[i])
        if d is not None:
            deadline = d
            i += 1
    if len(parts) >= i + 2 and parts[i].startswith(MODEL_FIELD_PREFIX):
        mt = parse_model(parts[i])
        if mt is not None:
            model_tag = mt
            i += 1
    return rid, list(parts[i:]), ctx, deadline, model_tag


def split_predict_deadline(parts: Sequence[str]):
    """Consumer-side parse of an already-split predict message:
    ``(request_id, row_fields, ctx_or_None, deadline_us_or_None)``.
    A model-routing field is stripped too (multi-model consumers use
    :func:`split_predict_route`)."""
    rid, row, ctx, deadline, _ = split_predict_route(parts)
    return rid, row, ctx, deadline


def split_predict(parts: Sequence[str]):
    """Consumer-side parse of an already-split predict message:
    ``(request_id, row_fields, ctx_or_None)``.  The trace field — when
    present and parseable — is stripped from the row whether or not it
    is sampled; unsampled or absent yields ctx None.  A deadline field
    is stripped too (callers that enforce deadlines use
    :func:`split_predict_deadline`)."""
    rid, row, ctx, _ = split_predict_deadline(parts)
    return rid, row, ctx


# --------------------------------------------------------------------------
# head-based stamping (the client side)
# --------------------------------------------------------------------------

def stamp_values(values: List[str], delim: str = ",",
                 broker: Optional[str] = None) -> List[str]:
    """Stamp every Nth un-stamped predict message in a push batch with
    the trace field, emitting the flow ``s`` start (client enqueue) for
    each stamped one.  With sampling off this is ONE global read and the
    input list is returned unchanged (same object, no scan)."""
    n = _sample_n
    if n <= 0:
        return values
    pred_prefix = "predict" + delim
    out: Optional[List[str]] = None
    for i, v in enumerate(values):
        if not v.startswith(pred_prefix):
            continue
        parts = v.split(delim, 2)
        if len(parts) < 3:
            continue
        if parse_field(parts[2].split(delim, 1)[0]) is not None:
            continue   # already stamped upstream (e.g. the shard ring)
        if next(_counter) % n:
            continue
        t = now_us()
        rid = parts[1]
        if out is None:
            out = list(values)
        out[i] = delim.join((parts[0], rid, encode_field(t), parts[2]))
        emit_flow("s", rid, "enqueue", ts_us=t, broker=broker)
    return out if out is not None else values


def stamp_deadline(values: List[str], ttl_ms: float,
                   delim: str = ",") -> List[str]:
    """Stamp every un-stamped request message in a push batch with an
    absolute deadline ``ttl_ms`` from now (the ``ps.request.ttl.ms``
    producer knob).  Rides AFTER a trace field when one is present;
    already-stamped messages keep their original deadline (a re-offer
    or re-route must not extend the budget).  ``ttl_ms <= 0`` returns
    the input unchanged (same object)."""
    if not ttl_ms or ttl_ms <= 0:
        return values
    field = encode_deadline(now_us() + float(ttl_ms) * 1e3)
    out: Optional[List[str]] = None
    for i, v in enumerate(values):
        parts = v.split(delim)
        if parts[0] not in ("predict", "predictq") or len(parts) < 3:
            continue
        j = 2
        if len(parts) > j + 1 and parse_field(parts[j]) is not None:
            j += 1
        if len(parts) > j + 1 and parse_deadline(parts[j]) is not None:
            continue
        if out is None:
            out = list(values)
        out[i] = delim.join(parts[:j] + [field] + parts[j:])
    return out if out is not None else values


def stamp_model(values: List[str], model_spec: str,
                delim: str = ",") -> List[str]:
    """Stamp every un-stamped predict message in a push batch with a
    model-routing field (``ps.client.model`` producer knob;
    ``model_spec`` is ``<name>`` or ``<name>:<version>``).  Rides AFTER
    trace and deadline fields when present; already-tagged messages keep
    their original tag (a re-offer must not re-route).  A false-y spec
    returns the input unchanged (same object)."""
    if not model_spec:
        return values
    if parse_model(MODEL_FIELD_PREFIX + str(model_spec)) is None:
        raise ValueError(f"bad model spec: {model_spec!r}")
    field = MODEL_FIELD_PREFIX + str(model_spec)
    out: Optional[List[str]] = None
    for i, v in enumerate(values):
        parts = v.split(delim)
        if parts[0] not in ("predict", "predictq") or len(parts) < 3:
            continue
        j = 2
        if len(parts) > j + 1 and parse_field(parts[j]) is not None:
            j += 1
        if len(parts) > j + 1 and parse_deadline(parts[j]) is not None:
            j += 1
        if len(parts) > j + 1 and parse_model(parts[j]) is not None:
            continue
        if out is None:
            out = list(values)
        out[i] = delim.join(parts[:j] + [field] + parts[j:])
    return out if out is not None else values


def maybe_sample_local() -> Optional[RequestTrace]:
    """Head sampling for the in-process transport (``submit()``): every
    Nth submit gets a context with a process-unique synthetic id.  One
    global read when off."""
    n = _sample_n
    if n <= 0 or next(_counter) % n:
        return None
    t = now_us()
    rid = f"inproc-{os.getpid()}-{next(_local_ids)}"
    ctx = RequestTrace(rid, t, wire=False)
    emit_flow("s", rid, "enqueue", ts_us=t, broker="inprocess")
    return ctx


configure_from_env()
