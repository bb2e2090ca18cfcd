"""Inspect / verify / GC a serving model registry (``serving/registry.py``):
the port's copy of the JAX package's ``tools/registrytool.py``, over
``avenir_tpu_torch.serving.registry``, with the same output lines and exit
codes over a registry either package wrote.

    python -m avenir_tpu_torch.tools.registrytool <command> ...

    list   <registry-dir> [--name <model>]
    verify <registry-dir> [--name <model>]
    gc     <registry-dir> [--name <model>] [--keep 3] [--dry-run]

``list`` prints, grouped per model name, every committed version with
its kind, intactness, payload files, on-disk bytes, and the pin/serving
resolution — the operator's view of what a hot-swap refresh (or a
multi-model router's resident set) would actually load.  Each
version line flags ``*`` = the serving resolution and ``P`` = the
explicit pin, per NAME — N resident models on one fleet means N
independent pin/serving answers.

``verify`` probes every version with the registry's own ``is_intact``
(meta.json parses, every manifest file opens) plus a pin-target check,
and audits delta sidecars: a delta whose parent version is
gone/torn flags ``orphaned-delta``; one whose recorded parent sha chain
no longer matches the parent's trees flags ``delta-sha-chain-broken``.
Both are warnings, not failures — serving always has the full-artifact
fallback.  Exit code 0 = all intact, 1 = problems found, 2 = usage
error.

``gc`` retires old versions through ``ModelRegistry.retire`` (keeps the
newest ``--keep``, never the pinned or serving version, sweeps abandoned
``.tmp`` publishes).  ``--keep`` applies PER NAME: without ``--name``
every model in the registry is swept independently, each keeping its
own newest ``--keep`` — one tenant's publish cadence never shrinks a
co-resident tenant's retention.  ``--dry-run`` prints what WOULD go.
This is the retention story behind the retrain controller's publish
cadence (``dtb.retrain.retire.keep.last`` runs the same call in-loop).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..serving.registry import META_FILE, ModelRegistry


def _dir_bytes(d: str) -> int:
    total = 0
    for root, _, files in os.walk(d):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def _names(reg: ModelRegistry, only: str | None):
    if only:
        return [only]
    return reg.names()


def cmd_list(args) -> int:
    reg = ModelRegistry(args.registry)
    names = _names(reg, args.name)
    if not names:
        print(f"no models in {reg.base_dir!r}", file=sys.stderr)
        return 1
    if len(names) > 1:
        print(f"{len(names)} model(s) in {reg.base_dir!r} — pin and "
              f"serving resolve independently per name")
    for name in names:
        pin = reg.pinned_version(name)
        serving = reg.serving_version(name)
        print(f"{name}: pinned={pin if pin is not None else '-'} "
              f"serving={serving if serving is not None else '-'}")
        print(f"  {'ver':>6} {'intact':>7} {'kind':>8} {'bytes':>10}  "
              f"files")
        for v in reg.versions(name):
            d = reg.version_dir(name, v)
            kind, files = "?", []
            try:
                with open(os.path.join(d, META_FILE)) as fh:
                    meta = json.load(fh)
                kind = meta.get("kind", "?")
                files = meta.get("files") or []
            except Exception:
                pass
            # '*' = what a refresh serves, 'P' = the explicit pin —
            # usually the same version, but a pin to a torn version
            # shows as P on one line and * on the intact fallback
            mark = ("*" if v == serving else " ") \
                + ("P" if v == pin else " ")
            print(f"  {v:>5}{mark} {str(reg.is_intact(name, v)):>6} "
                  f"{kind:>8} {_dir_bytes(d):>10}  {' '.join(files)}")
    return 0


def cmd_verify(args) -> int:
    reg = ModelRegistry(args.registry)
    names = _names(reg, args.name)
    if not names:
        # same contract as cmd_list: a missing/empty registry (typo'd
        # path) must NOT read as 'verified' to a gating script
        print(f"no models in {reg.base_dir!r}", file=sys.stderr)
        return 1
    problems = 0
    for name in names:
        versions = reg.versions(name)
        if not versions:
            print(f"{name}: NO committed versions")
            problems += 1
            continue
        vset = set(versions)
        warned = 0
        for v in versions:
            if not reg.is_intact(name, v):
                print(f"{name} v{v}: TORN or unreadable")
                problems += 1
                continue
            # delta-sidecar sha-chain probes.  These are
            # WARNINGS, not problems: a broken chain only disables the
            # O(delta) fast path — refresh falls back to the version's
            # own full artifact, which is intact.
            note = ""
            dmeta = reg.delta_info(name, v)
            if dmeta is not None:
                parent = dmeta.get("parent_version")
                if parent not in vset or not reg.is_intact(name, parent):
                    note = (f"  [orphaned-delta: parent v{parent} "
                            f"missing/torn — delta unusable, full load "
                            f"serves]")
                    warned += 1
                else:
                    try:
                        pmeta = reg.load(name, parent).meta
                        pshas = pmeta.get("tree_shas")
                    except Exception:
                        pshas = None
                    if pshas != dmeta.get("parent_tree_shas"):
                        note = (f"  [delta-sha-chain-broken: parent "
                                f"v{parent} trees differ from the "
                                f"recorded chain — delta unusable, "
                                f"full load serves]")
                        warned += 1
            print(f"{name} v{v}: ok{note}")
        pin = reg.pinned_version(name)
        if pin is not None and not reg.is_intact(name, pin):
            print(f"{name}: pin -> v{pin} whose target is NOT intact "
                  f"(serving falls back to newest intact)")
            problems += 1
        if warned:
            print(f"{name}: {warned} delta warning(s) — serving is safe "
                  f"(full-artifact fallback), delta distribution is not")
    print(f"{'PROBLEMS: %d' % problems if problems else 'verified'}")
    return 1 if problems else 0


def cmd_gc(args) -> int:
    reg = ModelRegistry(args.registry)
    names = _names(reg, args.name)
    if args.name and not reg.versions(args.name):
        print(f"no committed versions of {args.name!r} in "
              f"{reg.base_dir!r}", file=sys.stderr)
        return 1
    if not names:
        print(f"no models in {reg.base_dir!r}", file=sys.stderr)
        return 1
    # keep_last applies PER NAME: each resident model keeps its own
    # newest --keep (minus pin/serving protection) — one noisy tenant's
    # publish cadence must not evict a quiet co-resident's history
    for name in names:
        versions = reg.versions(name)
        if not versions:
            continue
        if args.dry_run:
            # retire(dry_run=True) computes the keep rule — ONE source
            # of truth, never a re-implementation that can drift from it
            would = reg.retire(name, keep_last=args.keep, dry_run=True)
            print(f"{name}: would retire {would or 'nothing'} "
                  f"(keep {[v for v in versions if v not in would]}; "
                  f"dead .tmp publishes would be swept)")
            continue
        retired = reg.retire(name, keep_last=args.keep)
        print(f"{name}: retired {retired or 'nothing'} "
              f"(kept {reg.versions(name)})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="registrytool", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("list", help="per-model version table")
    p.add_argument("registry")
    p.add_argument("--name")
    p.set_defaults(fn=cmd_list)
    p = sub.add_parser("verify", help="probe every version intact")
    p.add_argument("registry")
    p.add_argument("--name")
    p.set_defaults(fn=cmd_verify)
    p = sub.add_parser("gc", help="retire old versions (--keep applies "
                                  "per model name)")
    p.add_argument("registry")
    p.add_argument("--name",
                   help="one model; default sweeps EVERY name, each "
                        "keeping its own newest --keep")
    p.add_argument("--keep", type=int, default=3)
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(fn=cmd_gc)
    try:
        args = ap.parse_args(argv)
    except SystemExit as exc:
        return 2 if exc.code not in (0, None) else 0
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
