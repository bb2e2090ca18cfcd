"""Operator tooling over the telemetry artifacts: the port's copy of the
JAX package's ``tools/tracetool.py``, over ``avenir_tpu_torch.telemetry.
trace``, with the same output lines and exit codes over traces and
counters either package wrote.  The one addition: the backend table of
``summarize --counters`` also names the port's forms (``cuda``, ``torch``,
``host``), which the JAX tool prints as ``?``.

    python -m avenir_tpu_torch.tools.tracetool <command> ...

    summarize     <trace.jsonl> [...]
    merge         -o merged.json <trace.jsonl> [...]
    chrome-export <trace.jsonl> [-o out.json]
    counter-diff  <a/counters.json> <b/counters.json>
    request       <request_id> <trace.jsonl> [...]
    incident      <t0> <t1> <trace.jsonl> [...]

* **summarize** — per-stage span accounting (count, total/mean ms) plus
  per-lane totals and the observed wall span, for one or many per-process
  trace files (pass every shard's file to see the whole run).  With
  ``--counters <out>.counters.json`` it additionally prints the per-site
  kernel-backend table (xla vs pallas vs quantized, from the dispatch
  ledger's ``KernelBackends`` group) so a trace shows WHICH kernel form
  actually ran at each hot site.  Traces carrying
  ``autoscaler.decision`` instants get the decision log printed next to
  the serving-lane breakdown — scale actions with their sensed inputs
  (queue depth, depth derivative, recent p99), hold runs compressed —
  so an operator can replay WHY the fleet scaled.
  Multi-model traces additionally get the per-model table —
  batches, rows, mean fill, p99 and admission rejections by model
  label — the per-tenant view of one fleet's device time.
* **merge** — concatenate N per-process JSONL traces (the shards of one
  run) into ONE ts-sorted Chrome trace JSON; epoch-anchored timestamps
  make shard skew visible as lane offset.  Warns when the inputs carry
  different run ids (sometimes intended: a resumed run's tail).
* **chrome-export** — single-file variant of merge.
* **counter-diff** — diff two jobs' ``counters.json`` dumps (the file
  cli.run now writes next to every job output): every (group, name) with
  its a/b values and delta — the regression-hunting view over reruns.
* **request** — reconstruct ONE sampled request's timeline from its flow
  events (client enqueue -> broker shard -> worker pop -> batch dispatch
  -> reply push) across however many per-process files hold its legs,
  plus the component decomposition carried on the flow finish — the
  "where did request X spend its 400 ms" answer.  On a
  multi-model fleet the header names the model the request routed to
  (the ``m=`` spec off the worker-pop leg).
* **incident** — a time-window report over the merged traces: autoscaler
  decisions, broker reconnects/shard deaths, controller stage spans and
  decisions, registry publish/pin flips, degradation instants, and the
  sampled-request latency picture (p99 + slowest request ids) before vs
  after the window midpoint, plus the per-model serving table when the
  window holds multi-model traffic.  ``t0``/``t1`` are epoch seconds (values
  above 1e12 are taken as epoch microseconds, the trace's native unit).

Exit status: 0 on success, 1 on invalid input (schema problems are
printed but do not fail merge/export — a torn shard file should not stop
the operator from looking at the intact ones).  ``request`` with an
unknown id and ``incident`` with an empty window exit 1 with a named
message on stderr, same contract as ``summarize``.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List

from ..telemetry.trace import (merge_trace_files, read_trace_file,
                               validate_trace_events, write_chrome_trace)


def _run_ids(paths: List[str]) -> Dict[str, str]:
    ids = {}
    for p in paths:
        for ev in read_trace_file(p):
            if ev.get("run_id"):
                ids[p] = ev["run_id"]
                break
    return ids


# the JAX package's forms, then the port's (kernels/dispatch.py)
_BACKENDS = ("xla", "pallas", "quantized", "cuda", "torch", "host")


def _print_backend_table(counters_path: str) -> None:
    """The per-site backend column: join the ``Dispatches`` site counts
    with the ``KernelBackends`` executed-form tallies from one job's
    counters.json (tracing.TransferLedger.export)."""
    with open(counters_path) as fh:
        groups = json.load(fh)
    sites = dict(groups.get("Dispatches") or {})
    kb = groups.get("KernelBackends") or {}
    by_site: Dict[str, List[str]] = defaultdict(list)
    for key, n in sorted(kb.items()):
        site, _, backend = key.rpartition(".")
        if backend not in _BACKENDS:   # malformed key: show verbatim
            site, backend = key, "?"
        by_site[site].append(f"{backend}({n})")
    if not by_site and not sites:
        print(f"\n(no dispatch/backend counters in {counters_path})")
        return
    print(f"\nhot-site kernel backends ({counters_path}):")
    print(f"  {'site':<24}{'dispatches':>12}  backend(launches)")
    for site in sorted(set(by_site) | set(sites)):
        disp = sites.get(site, "-")
        forms = " ".join(by_site.get(site, [])) or "-"
        print(f"  {site:<24}{disp!s:>12}  {forms}")


def _print_model_table(events) -> None:
    """The per-model (per-tenant) serving breakdown: every
    ``serve.predict`` span carries the model label of the resident that
    ran it, and ``serve.rejected`` instants carry the tenant whose OWN
    admission depth shed the request — so a multi-model fleet's trace
    answers 'which tenant burned the device, which tenant got shed'
    without the scrape endpoint."""
    by_model: Dict[str, List[dict]] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("name") == "serve.predict" \
                and isinstance(e.get("ts"), (int, float)):
            m = str((e.get("args") or {}).get("model") or "")
            by_model[m].append(e)
    rejected: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("ph") == "i" and e.get("name") == "serve.rejected":
            rejected[str((e.get("args") or {}).get("model") or "")] += 1
    if not by_model and not rejected:
        return
    print("\nper-model serving (serve.predict by model label):")
    print(f"  {'model':<18}{'batches':>8}{'rows':>8}{'mean fill':>10}"
          f"{'p99 ms':>9}{'rejected':>10}")
    for m in sorted(set(by_model) | set(rejected)):
        evs = by_model.get(m, [])
        rows = [int((e.get("args") or {}).get("rows", 0)) for e in evs]
        durs = sorted(float(e.get("dur", 0.0)) / 1e3 for e in evs)
        p99 = durs[min(len(durs) - 1, int(0.99 * len(durs)))] \
            if durs else 0.0
        label = m or "(default)"
        print(f"  {label:<18}{len(evs):>8}{sum(rows):>8}"
              f"{(sum(rows) / max(len(evs), 1)):>10.1f}"
              f"{p99:>9.3f}{rejected.get(m, 0):>10}")


def _print_autoscaler_log(events) -> None:
    """The sensor→policy→actuator replay: every ``autoscaler.decision``
    instant, scale actions printed verbatim with their sensed inputs,
    runs of holds compressed to one line — WHY the fleet scaled, next to
    the serving-lane view of WHAT it was serving."""
    decisions = sorted(
        (e for e in events if e.get("ph") == "i"
         and e.get("name") == "autoscaler.decision"
         and isinstance(e.get("ts"), (int, float))),
        key=lambda e: float(e["ts"]))
    if not decisions:
        return
    t0 = float(decisions[0]["ts"])
    actions = [e for e in decisions
               if e.get("args", {}).get("action") in ("up", "down")]
    print(f"\nautoscaler decisions ({len(decisions)} ticks, "
          f"{len(actions)} scale actions):")
    held = 0
    for e in decisions:
        a = e.get("args", {})
        if a.get("action") not in ("up", "down"):
            held += 1
            continue
        if held:
            print(f"  ... {held} hold tick(s) ...")
            held = 0
        print(f"  +{(float(e['ts']) - t0) / 1e6:8.2f}s "
              f"{a.get('action', '?'):<5} "
              f"active {a.get('active')}->{a.get('new_active')}  "
              f"depth {a.get('depth')}  "
              f"d(depth)/dt {a.get('derivative_per_s')}/s  "
              f"p99 {a.get('p99_ms')}ms"
              + (f" (slo {a.get('slo_p99_ms')}ms)"
                 if a.get("slo_p99_ms") else ""))
    if held:
        print(f"  ... {held} hold tick(s) ...")


def cmd_summarize(args) -> int:
    events = merge_trace_files(args.traces)
    problems = validate_trace_events(events)
    for pr in problems:
        print(f"[schema] {pr}", file=sys.stderr)
    # malformed X events (no numeric ts) are already reported as
    # [schema] problems above — keep them out of the accounting so a
    # torn line yields the documented exit 1, not a KeyError traceback
    spans = [e for e in events if e.get("ph") == "X"
             and isinstance(e.get("ts"), (int, float))
             and isinstance(e.get("dur", 0.0), (int, float))]
    if not spans:
        print("no spans recorded")
        _print_autoscaler_log(events)
        for cpath in (args.counters or []):
            _print_backend_table(cpath)
        return 0 if not problems else 1
    by_name: Dict[str, List[float]] = defaultdict(list)
    lane_spans: Dict[tuple, List[tuple]] = defaultdict(list)
    for e in spans:
        by_name[e.get("name", "?")].append(float(e.get("dur", 0.0)))
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        lane_spans[(e.get("pid"), e.get("tid"))].append((ts, ts + dur))
    # busy time is the UNION of a lane's span intervals, not the sum of
    # durations: nested spans (allreduce.merge_topk wrapping its own
    # allgather) would otherwise double-count and report >100% of wall
    by_lane: Dict[tuple, float] = {}
    for lane, ivs in lane_spans.items():
        ivs.sort()
        busy, cur_lo, cur_hi = 0.0, None, None
        for lo, hi in ivs:
            if cur_hi is None or lo > cur_hi:
                if cur_hi is not None:
                    busy += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        if cur_hi is not None:
            busy += cur_hi - cur_lo
        by_lane[lane] = busy
    t_lo = min(float(e["ts"]) for e in spans)
    t_hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in spans)
    stalls = [e for e in events if e.get("ph") == "i"
              and e.get("name") == "allreduce.stall"]
    print(f"{len(spans)} spans over {len(by_lane)} lane(s), wall "
          f"{(t_hi - t_lo) / 1e3:.1f} ms")
    print(f"{'stage':<24}{'count':>8}{'total ms':>12}{'mean ms':>10}")
    for name in sorted(by_name, key=lambda n: -sum(by_name[n])):
        durs = by_name[name]
        tot = sum(durs) / 1e3
        print(f"{name:<24}{len(durs):>8}{tot:>12.1f}"
              f"{tot / len(durs):>10.3f}")
    print("\nper-lane busy time:")
    for (pid, tid), busy in sorted(by_lane.items()):
        print(f"  pid {pid} tid {tid}: {busy / 1e3:.1f} ms "
              f"({100.0 * busy / max(t_hi - t_lo, 1e-9):.0f}% of wall)")
    # serving lane breakdown: every lane that ran device predicts is one
    # fleet worker's predict thread — batches, how full they ran, and
    # what fraction of the lane's live window the device was busy
    serve_lanes: Dict[tuple, List[dict]] = defaultdict(list)
    for e in spans:
        if e.get("name") == "serve.predict":
            serve_lanes[(e.get("pid"), e.get("tid"))].append(e)
    if serve_lanes:
        print("\nserving lanes (serve.predict):")
        print(f"  {'lane':<18}{'batches':>8}{'rows':>8}{'mean fill':>10}"
              f"{'device-busy':>12}")
        for lane in sorted(serve_lanes):
            evs = serve_lanes[lane]
            rows = [int(e.get("args", {}).get("rows", 0)) for e in evs]
            busy_us = sum(float(e.get("dur", 0.0)) for e in evs)
            lo = min(float(e["ts"]) for e in evs)
            hi = max(float(e["ts"]) + float(e.get("dur", 0.0))
                     for e in evs)
            frac = busy_us / max(hi - lo, 1e-9)
            pid, tid = lane
            print(f"  pid {pid} tid {tid:<8}{len(evs):>8}{sum(rows):>8}"
                  f"{(sum(rows) / max(len(evs), 1)):>10.1f}"
                  f"{100.0 * frac:>11.0f}%")
    _print_model_table(events)
    _print_autoscaler_log(events)
    if stalls:
        print(f"\n{len(stalls)} STALL event(s):")
        for e in stalls:
            a = e.get("args", {})
            print(f"  shard {a.get('shard')} waited "
                  f"{a.get('waited_s')}s for {a.get('missing_shards')} "
                  f"({a.get('reducer')}/{a.get('phase')} step "
                  f"{a.get('step')})")
    for cpath in (args.counters or []):
        _print_backend_table(cpath)
    # documented exit contract: summarize fails on invalid input so a CI
    # lane can gate on it (merge/export only warn)
    return 0 if not problems else 1


def _merge_common(paths: List[str], out: str) -> int:
    ids = _run_ids(paths)
    if len(set(ids.values())) > 1:
        print(f"[warn] merging traces from different runs: "
              f"{sorted(set(ids.values()))}", file=sys.stderr)
    events = merge_trace_files(paths)
    problems = validate_trace_events(events)
    for pr in problems:
        print(f"[schema] {pr}", file=sys.stderr)
    write_chrome_trace(out, events)
    print(f"wrote {out} ({len(events)} events from {len(paths)} file(s)); "
          f"load in chrome://tracing or https://ui.perfetto.dev")
    return 0


def cmd_merge(args) -> int:
    return _merge_common(args.traces, args.output)


def cmd_chrome_export(args) -> int:
    out = args.output or (
        args.trace[:-len(".jsonl")] if args.trace.endswith(".jsonl")
        else args.trace) + ".chrome.json"
    return _merge_common([args.trace], out)


_FLOW_STEPS = {"s": "enqueue", "t": "step", "f": "reply"}


def _flow_events_of(events, rid: str) -> List[dict]:
    return sorted(
        (e for e in events
         if e.get("ph") in ("s", "t", "f") and str(e.get("id")) == rid
         and isinstance(e.get("ts"), (int, float))),
        key=lambda e: float(e["ts"]))


def _resolve_flow_id(events, rid: str):
    """Flow ids are namespaced ``<run_id>:<request_id>``; accept either
    the full form or the bare request id.  Returns ``(flow_id, None)``
    on a unique match, ``(None, candidates)`` when the bare id matches
    several runs' flows, ``(None, [])`` when nothing matches."""
    ids = {str(e.get("id")) for e in events
           if e.get("ph") in ("s", "t", "f")}
    if rid in ids:
        return rid, None
    cands = sorted(i for i in ids if i.split(":", 1)[-1] == rid)
    if len(cands) == 1:
        return cands[0], None
    return None, cands


def _print_request_timeline(events, rid: str) -> None:
    legs = _flow_events_of(events, rid)
    t0 = float(legs[0]["ts"])
    start = next((e for e in legs if e.get("ph") == "s"), None)
    finish = next((e for e in legs if e.get("ph") == "f"), None)
    wire_ms = (float(finish["ts"]) - float(start["ts"])) / 1e3 \
        if start is not None and finish is not None else None
    head = f"request {rid}: {len(legs)} flow leg(s)"
    if wire_ms is not None:
        head += f", wire {wire_ms:.3f} ms (enqueue -> reply push)"
    # the worker-pop leg carries the routed model spec on a multi-model
    # fleet: name or name:version, "" = the default model
    routed = next((str(e.get("args", {}).get("model"))
                   for e in legs if e.get("args", {}).get("model")), None)
    if routed is not None:
        head += f", routed model {routed}"
    print(head)
    for e in legs:
        a = e.get("args", {}) or {}
        step = a.get("step") or _FLOW_STEPS.get(e["ph"], "?")
        where = " ".join(f"{k}={a[k]}" for k in ("broker", "worker",
                                                 "host", "model", "rows")
                         if a.get(k))
        print(f"  +{(float(e['ts']) - t0) / 1e3:9.3f} ms  "
              f"{e['ph']} {step:<10} lane pid {e.get('pid')} "
              f"tid {e.get('tid')}" + (f"  [{where}]" if where else ""))
    if finish is not None:
        a = finish.get("args", {}) or {}
        comps = [(k[:-3], a[k]) for k in
                 ("queue_wait_ms", "coalesce_ms", "device_ms",
                  "reply_ms", "total_ms") if k in a]
        if comps:
            print("  components:")
            for name, ms in comps:
                print(f"    {name:<12}{float(ms):10.3f} ms")
            if wire_ms is not None and "total_ms" in a:
                print(f"    components sum to {float(a['total_ms']):.3f}"
                      f" ms vs wire {wire_ms:.3f} ms")


def cmd_request(args) -> int:
    events = merge_trace_files(args.traces)
    rid, cands = _resolve_flow_id(events, str(args.request_id))
    if rid is None:
        if cands:
            print(f"request {args.request_id!r}: ambiguous across "
                  f"{len(cands)} runs in these traces — pass the full "
                  f"flow id: {', '.join(cands)}", file=sys.stderr)
        else:
            print(f"request {args.request_id!r}: no flow events in "
                  f"{len(args.traces)} trace file(s) — unknown or "
                  f"unsampled request id", file=sys.stderr)
        return 1
    _print_request_timeline(events, rid)
    return 0


def _parse_epoch_us(raw: str) -> float:
    t = float(raw)
    return t if t > 1e12 else t * 1e6


def cmd_incident(args) -> int:
    t0_us, t1_us = _parse_epoch_us(args.t0), _parse_epoch_us(args.t1)
    if t1_us <= t0_us:
        t0_us, t1_us = t1_us, t0_us
    events = merge_trace_files(args.traces)

    def in_window(e) -> bool:
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            return False
        end = float(ts) + float(e.get("dur", 0.0) or 0.0)
        return end >= t0_us and float(ts) <= t1_us

    window = [e for e in events if in_window(e)]
    if not window:
        print(f"incident window [{t0_us / 1e6:.3f}, {t1_us / 1e6:.3f}] "
              f"(epoch s): no events in {len(args.traces)} trace "
              f"file(s) — empty window", file=sys.stderr)
        return 1
    print(f"incident report: {len(window)} event(s) over "
          f"{(t1_us - t0_us) / 1e6:.2f}s window")

    def offs(e) -> str:
        return f"+{(float(e['ts']) - t0_us) / 1e6:8.2f}s"

    # control plane: broker health, controller stages, registry flips,
    # degradations — the WHY lanes of the incident
    sections = (
        ("broker events", ("broker.reconnect", "broker.shard_down",
                           "broker.shard_up", "broker.redeliver",
                           "broker.journal_replay")),
        ("controller decisions", ("controller.decision",)),
        ("registry events", ("registry.publish", "registry.pin",
                             "registry.unpin")),
        ("degradations", ("serving.degraded",)),
        ("online learning", ("online.snapshot", "online.rollback",
                             "online.floor_breach")),
        ("collective stalls", ("allreduce.stall",)),
    )
    for title, names in sections:
        evs = [e for e in window if e.get("ph") == "i"
               and e.get("name") in names]
        if not evs:
            continue
        print(f"\n{title} ({len(evs)}):")
        for e in evs:
            a = e.get("args", {}) or {}
            detail = " ".join(f"{k}={v}" for k, v in sorted(a.items())
                              if v is not None)
            print(f"  {offs(e)} {e['name']}  {detail}")
    stages = [e for e in window if e.get("ph") == "X"
              and e.get("name") == "controller.stage"]
    if stages:
        print(f"\ncontroller stages ({len(stages)}):")
        for e in stages:
            a = e.get("args", {}) or {}
            print(f"  {offs(e)} {a.get('stage', '?')} "
                  f"(cycle {a.get('cycle', '?')}) "
                  f"{float(e.get('dur', 0.0)) / 1e3:.1f} ms")
    _print_model_table(window)
    _print_autoscaler_log(window)
    # the sampled-request latency picture: completed flows (s + f both
    # inside the merged traces) whose finish lands in the window, split
    # at the window midpoint — p99 + slowest exemplar ids before/after,
    # so "did the swap/scale action help" reads off one report
    starts: Dict[str, float] = {}
    for e in events:
        if e.get("ph") == "s" and isinstance(e.get("ts"), (int, float)):
            starts.setdefault(str(e.get("id")), float(e["ts"]))
    flows = []
    for e in window:
        if e.get("ph") != "f":
            continue
        rid = str(e.get("id"))
        if rid in starts:
            flows.append((float(e["ts"]),
                          (float(e["ts"]) - starts[rid]) / 1e3, rid))
    if flows:
        mid = (t0_us + t1_us) / 2.0

        def describe(label, part):
            if not part:
                print(f"  {label}: no sampled requests")
                return
            lats = sorted(ms for _, ms, _ in part)
            p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
            worst = sorted(part, key=lambda f: -f[1])[:3]
            ids = ", ".join(f"{rid} ({ms:.2f} ms)"
                            for _, ms, rid in worst)
            print(f"  {label}: {len(part)} request(s), p99 "
                  f"{p99:.2f} ms; slowest: {ids}")
        print(f"\nsampled requests ({len(flows)} completed in window, "
              f"split at window midpoint):")
        describe("before", [f for f in flows if f[0] < mid])
        describe("after ", [f for f in flows if f[0] >= mid])
    return 0


def cmd_counter_diff(args) -> int:
    with open(args.a) as fh:
        a = json.load(fh)
    with open(args.b) as fh:
        b = json.load(fh)
    keys = sorted({(g, n) for g, names in a.items() for n in names} |
                  {(g, n) for g, names in b.items() for n in names})
    print(f"{'group/name':<44}{'a':>14}{'b':>14}{'delta':>14}")
    changed = 0
    for g, n in keys:
        va = a.get(g, {}).get(n)
        vb = b.get(g, {}).get(n)
        if va == vb and not args.all:
            continue
        changed += 1
        da = "-" if va is None else va
        db = "-" if vb is None else vb
        delta = (vb - va) if isinstance(va, (int, float)) \
            and isinstance(vb, (int, float)) else ""
        print(f"{g + '/' + n:<44}{da!s:>14}{db!s:>14}{delta!s:>14}")
    if changed == 0:
        print("(no differences)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tracetool", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="per-stage span accounting")
    p.add_argument("traces", nargs="+")
    p.add_argument("--counters", action="append",
                   help="a job's <out>.counters.json: print the per-site "
                        "kernel-backend table (repeatable)")
    p.set_defaults(fn=cmd_summarize)

    p = sub.add_parser("merge",
                       help="merge N per-process traces into one Chrome "
                            "trace JSON")
    p.add_argument("traces", nargs="+")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_merge)

    p = sub.add_parser("chrome-export",
                       help="export one trace file as Chrome trace JSON")
    p.add_argument("trace")
    p.add_argument("-o", "--output")
    p.set_defaults(fn=cmd_chrome_export)

    p = sub.add_parser("request",
                       help="one sampled request's cross-process "
                            "timeline + component decomposition")
    p.add_argument("request_id")
    p.add_argument("traces", nargs="+")
    p.set_defaults(fn=cmd_request)

    p = sub.add_parser("incident",
                       help="time-window report: autoscaler/broker/"
                            "controller/registry events + sampled-"
                            "request p99 exemplars before/after")
    p.add_argument("t0", help="window start, epoch seconds (or epoch "
                              "microseconds when > 1e12)")
    p.add_argument("t1", help="window end, same unit")
    p.add_argument("traces", nargs="+")
    p.set_defaults(fn=cmd_incident)

    p = sub.add_parser("counter-diff",
                       help="diff two runs' counters.json dumps")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--all", action="store_true",
                   help="print unchanged counters too")
    p.set_defaults(fn=cmd_counter_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
