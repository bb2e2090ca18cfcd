"""Inspect / verify / drop a columnar cache sidecar (io/colcache.py).

The port's copy of the JAX package's ``tools/cachetool.py``, over
``avenir_tpu_torch.io.colcache``: the same output lines and exit codes over
an ``.avtc`` sidecar either package built (the format is shared).

    python -m avenir_tpu_torch.tools.cachetool inspect <csv-or-.avtc-dir>
    python -m avenir_tpu_torch.tools.cachetool verify  <csv-or-.avtc-dir>
                                      [--schema s.json] [--delim ,]
    python -m avenir_tpu_torch.tools.cachetool drop    <csv-or-.avtc-dir>

``inspect`` prints the header (build id, fingerprint, source stamp, chunk
budget) and a per-chunk table: rows, source-row range, bad-record count,
bytes, and the packed dtype of every column block — the operator's view of
what the packing rules actually chose for a dataset.

``verify`` additionally recomputes every block's crc32 and cross-checks
row totals (and, given ``--schema``, the fingerprint; given a CSV target
that still exists, source freshness).  Exit code 0 = verified, 1 =
problems found, 2 = usage error.

``drop`` removes the sidecar directory (the cache is write-once: drop +
a ``cache.policy=build`` pass is the rebuild story).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..io import colcache


def _resolve_dir(target: str) -> str:
    """Accept the CSV path or the sidecar directory itself — including a
    custom ``dtb.streaming.cache.dir`` location that does not carry the
    ``.avtc`` suffix (identified by its ``header.json``)."""
    if os.path.isdir(target) and (
            target.endswith(colcache.SIDECAR_SUFFIX)
            or os.path.exists(os.path.join(target, colcache.HEADER_NAME))):
        return target
    return target + colcache.SIDECAR_SUFFIX


def cmd_inspect(args) -> int:
    cdir = _resolve_dir(args.target)
    header = colcache.read_header(cdir)
    if header is None:
        print(f"no readable {colcache.HEADER_NAME} in {cdir!r} "
              f"(not a cache, or an interrupted build)", file=sys.stderr)
        return 1
    top = {k: header[k] for k in ("format", "build_id", "fingerprint",
                                  "source", "source_name", "delim",
                                  "chunk_rows", "n_chunks", "n_rows",
                                  "n_bad", "built_unix") if k in header}
    print(json.dumps(top, indent=2, sort_keys=True))
    print(f"{'chunk':>5} {'rows':>10} {'src_range':>21} {'bad':>5} "
          f"{'bytes':>10}  dtypes")
    for idx, meta in enumerate(header.get("chunks", [])):
        dtypes = ""
        try:
            manifest, _ = colcache.read_chunk_file(
                colcache.CacheWriter.chunk_path(cdir, idx),
                header.get("build_id"))
            dtypes = " ".join(
                f"{c['ordinal']}:{c['kind']}:{c['dtype']}"
                for c in manifest["cols"])
        except colcache.CacheChunkError as exc:
            dtypes = f"TORN ({exc})"
        print(f"{idx:>5} {meta['rows']:>10} "
              f"[{meta['source_row_start']:>9},{meta['source_row_end']:>9})"
              f" {meta['bad']:>5} {meta['bytes']:>10}  {dtypes}")
    tail = header.get("tail_bad") or {}
    if tail.get("src"):
        print(f"tail bad records (after the last chunk): "
              f"{len(tail['src'])} at source rows {tail['src']}")
    return 0


def cmd_verify(args) -> int:
    cdir = _resolve_dir(args.target)
    schema = None
    if args.schema:
        from ..core.schema import FeatureSchema
        schema = FeatureSchema.load(args.schema)
    csv_path = None
    if not args.target.endswith(colcache.SIDECAR_SUFFIX) \
            and os.path.isfile(args.target):
        csv_path = args.target
    problems = colcache.verify_cache(cdir, schema=schema,
                                     csv_path=csv_path, delim=args.delim)
    if problems:
        for p in problems:
            print(f"PROBLEM: {p}", file=sys.stderr)
        print(f"{cdir}: {len(problems)} problem(s)", file=sys.stderr)
        return 1
    header = colcache.read_header(cdir) or {}
    print(f"{cdir}: verified ({header.get('n_chunks', 0)} chunks, "
          f"{header.get('n_rows', 0)} rows, {header.get('n_bad', 0)} "
          f"bad records on manifest)")
    return 0


def cmd_drop(args) -> int:
    cdir = _resolve_dir(args.target)
    if colcache.drop_cache(cdir):
        print(f"dropped {cdir}")
        return 0
    print(f"nothing to drop at {cdir!r}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="cachetool", description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("inspect", cmd_inspect), ("verify", cmd_verify),
                     ("drop", cmd_drop)):
        p = sub.add_parser(name)
        p.add_argument("target", help="CSV path or .avtc sidecar dir")
        if name == "verify":
            p.add_argument("--schema", default=None,
                           help="schema JSON to fingerprint-check against")
            p.add_argument("--delim", default=",")
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
