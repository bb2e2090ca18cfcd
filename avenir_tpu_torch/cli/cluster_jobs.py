"""Cluster-pack jobs (org.avenir.cluster.*, the distance store): the port of
``avenir_tpu/cli/cluster_jobs.py``.

Config-key namespaces follow the reference setup() methods:
kmc.* (cluster/KmeansCluster.java:104-127, including the reference's
``kmc.attr.odinals`` typo) and agg.* (cluster/AgglomerativeGraphical.java:39-46).
Every job runs on the process's device (``cuda`` unless
``-Dplatform=cpu``) and raises without a GPU when asked for one; the
host-only jobs resolve it too.  ``kmeansCluster`` takes an optional
``profile`` (``utils.tracing.LayerProfile``) that collects the wall of
each layer.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import Counters
from ..core.table import load_csv
from ..runtime import resolve_device
from ..utils.tracing import LayerProfile, layer
from .jobs import _schema_path, _splitter, register


@register("org.avenir.cluster.KmeansCluster", "kmeansCluster",
          dist="sharded")
def kmeans_cluster(cfg: Config, in_path: str, out_path: str,
                   profile: Optional[LayerProfile] = None) -> Counters:
    """One Lloyd iteration over every active cluster group (one reference MR
    pass, cluster/KmeansCluster.java).  Keys: kmc.schema.file.path,
    kmc.attr.odinals, kmc.movement.threshold, kmc.cluster.file.path,
    kmc.num.iterations (extension: loop in-process instead of re-running the
    job; default 1 = reference behavior), nads.output.precision.

    Multi-process (dist=sharded): each process loads its OWN data shard;
    the per-shard assignment sums are all-reduced before the centroid
    update (kmeans.KMeansEngine.iterate), so every process derives the
    identical global centroids from its local rows — the reference
    reducer's shuffle as a collective.  The cluster (centroid) file is
    replicated side input."""
    from ..cluster import kmeans as KM
    from ..parallel.distributed import process_index
    dev = resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "kmc.schema.file.path")
    ordinals = cfg.get_int_list("kmc.attr.odinals",
                                cfg.get_int_list("kmc.attr.ordinals"))
    if not ordinals:
        raise ValueError("missing attribute ordinals (kmc.attr.odinals)")
    threshold = cfg.must_get_float("kmc.movement.threshold",
                                   "missing movement threshold")
    precision = cfg.get_int("nads.output.precision", 3)
    iters = cfg.get_int("kmc.num.iterations", 1)
    with layer(profile, "parse"):
        table = load_csv(in_path, schema, cfg.field_delim_regex)
        lines = artifacts.read_text_input(cfg.must_get(
            "kmc.cluster.file.path", "missing cluster file"))
    engine = KM.KMeansEngine(schema, ordinals,
                             cfg.get("kmc.distance.metric", "euclidean"),
                             device=dev)
    groups = KM.parse_cluster_lines(lines, schema.num_columns, threshold,
                                    cfg.field_delim_out)
    groups, it = KM.run_kmeans(table, groups, engine,
                               max_iter=max(iters, 1), precision=precision,
                               profile=profile)
    with layer(profile, "write"):
        out_lines = KM.format_cluster_lines(groups, cfg.field_delim_out,
                                            precision)
        artifacts.write_text_output(out_path, out_lines)
    # iteration/active tallies describe the GLOBAL model every process
    # derived identically; emit once so the joined counter SUM is exact
    p0 = process_index() == 0
    counters.increment("Clustering", "iterations", it if p0 else 0)
    for g in groups:
        counters.increment("Clustering", "activeGroups",
                           int(g.active) if p0 else 0)
    return counters


@register("org.avenir.cluster.AgglomerativeGraphical", "agglomerativeGraphical",
          dist="gather")
def agglomerative_graphical(cfg: Config, in_path: str, out_path: str
                            ) -> Counters:
    """Greedy edge-weighted agglomerative pass
    (cluster/AgglomerativeGraphical.java).  Keys:
    agg.min.av.edge.weight.threshold, agg.map.file.dir.path (distance-store
    lines, or a store directory the entityDistanceStore job wrote),
    agg.dist.scale (set when the store holds distances rather than
    similarities)."""
    from ..cluster import agglomerative as AG
    resolve_device()
    counters = Counters()
    threshold = cfg.must_get_float("agg.min.av.edge.weight.threshold",
                                   "missing min average edge weight")
    map_path = cfg.must_get("agg.map.file.dir.path",
                            "missing distance map file")
    ps = None
    if os.path.isdir(map_path) and os.path.exists(
            os.path.join(map_path, "index.json")):
        # persistent MapFile-equivalent store (io.diststore) built by the
        # entityDistanceStore job: seek-per-key, nothing preloaded
        from ..io.diststore import EntityDistanceStore as _PStore
        ps = _PStore(map_path)

        class _LazyStore:
            # memo: try_membership probes the same entities repeatedly, so
            # parse each distance line at most once
            _cache: dict = {}

            def read(self, key):
                hit = self._cache.get(key)
                if hit is None:
                    hit = dict(ps.read(key) or [])
                    self._cache[key] = hit
                return hit

        store = _LazyStore()
    else:
        store = AG.EntityDistanceStore.from_lines(
            artifacts.read_text_input(map_path), cfg.field_delim_out)
    dist_scale = cfg.get_float("agg.dist.scale")
    split = _splitter(cfg.field_delim_regex)
    entity_ids: List[str] = []
    for line in artifacts.read_text_input(in_path):
        line = line.strip()
        if line:
            entity_ids.append(split(line)[0])
    try:
        clusters = AG.agglomerative_cluster(entity_ids, store, threshold,
                                            dist_scale)
    finally:
        if ps is not None:
            ps.close()
    artifacts.write_text_output(
        out_path, [c.to_line(cfg.field_delim_out) for c in clusters])
    counters.increment("Clustering", "clusters", len(clusters))
    return counters


@register("org.avenir.util.EntityDistanceMapFileAccessor",
          "entityDistanceStore",
          dist="gather")
def entity_distance_store(cfg: Config, in_path: str, out_path: str
                          ) -> Counters:
    """Build the persistent random-access distance store from entity-distance
    lines (util/EntityDistanceMapFileAccessor.write :69-92: key = first
    field, value = the rest).  out_path becomes the store directory."""
    from ..io.diststore import EntityDistanceStore as _PStore
    resolve_device()
    counters = Counters()
    store = _PStore.write(artifacts.read_text_input(in_path), out_path,
                          cfg.field_delim_out)
    counters.set("DistanceStore", "entities", len(store.keys()))
    return counters
