"""Graph-based agglomerative clustering over a precomputed entity-distance
store: the port of ``avenir_tpu/cluster/agglomerative.py`` (host code,
copied).  Cluster ids are ``uuid4`` hex strings, as in the JAX package, so
two runs agree on every field but the first.

Reference: cluster/AgglomerativeGraphical.java (map-only greedy pass: each
entity joins the existing cluster that maximizes average edge weight, or seeds
a new cluster, :57-81) + cluster/EdgeWeightedCluster.java (incremental
average-edge-weight update, :33-55) + util/EntityDistanceMapFileAccessor.java
(Hadoop MapFile of per-entity distance lists, :42-89).

The algorithm is inherently sequential/greedy (cluster membership of entity i
depends on entities 0..i-1), so it stays host-side; the expensive part — the
all-pairs distances the store holds — is produced by
ops.distance.DistanceComputer.  The store replaces the MapFile with a plain
dict keyed by entity id, serializable to the same ``key<d>ent<d>dist...`` text
lines.
"""

from __future__ import annotations

import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np


class EntityDistanceStore:
    """Random-access per-entity distance lists (MapFile equivalent)."""

    def __init__(self, data: Optional[Dict[str, Dict[str, float]]] = None):
        self.data: Dict[str, Dict[str, float]] = data or {}

    # ---- construction ----
    @classmethod
    def from_lines(cls, lines: Sequence[str], delim: str = ","
                   ) -> "EntityDistanceStore":
        """Each line: ``entity,other1,dist1,other2,dist2,...`` (the write
        format of EntityDistanceMapFileAccessor.write/read)."""
        data: Dict[str, Dict[str, float]] = {}
        for line in lines:
            line = line.strip()
            if not line:
                continue
            parts = line.split(delim)
            ent, rest = parts[0], parts[1:]
            data[ent] = {rest[i]: float(rest[i + 1])
                         for i in range(0, len(rest) - 1, 2)}
        return cls(data)

    @classmethod
    def from_matrix(cls, ids: Sequence[str], dist: np.ndarray
                    ) -> "EntityDistanceStore":
        data = {ids[i]: {ids[j]: float(dist[i, j])
                         for j in range(len(ids)) if j != i}
                for i in range(len(ids))}
        return cls(data)

    def to_lines(self, delim: str = ",") -> List[str]:
        lines = []
        for ent in sorted(self.data):
            flat: List[str] = [ent]
            for other, d in self.data[ent].items():
                flat += [other, f"{d:.6f}"]
            lines.append(delim.join(flat))
        return lines

    def read(self, key: str) -> Dict[str, float]:
        return self.data.get(key, {})


class EdgeWeightedCluster:
    """Reference cluster/EdgeWeightedCluster.java: running average edge weight
    over the clique induced by members; distances convert to weights as
    (distScale - dist) when the store holds distances."""

    def __init__(self, dist_scale: Optional[float] = None):
        self.id = uuid.uuid4().hex
        self.members: List[str] = []
        self.av_edge_weight = 0.0
        self.dist_scale = dist_scale

    def _weight(self, dist: float) -> float:
        return self.dist_scale - dist if self.dist_scale is not None else dist

    def try_membership(self, entity: str, store: EntityDistanceStore) -> float:
        """Average edge weight if ``entity`` were added (reference
        EdgeWeightedCluster.java:33-55)."""
        weight_sum = 0.0
        for member in self.members:
            d = store.read(member).get(entity)
            if d is None:
                d = store.read(entity).get(member)
            if d is not None:
                weight_sum += self._weight(d)
        k = len(self.members)
        num_edges = (k * (k - 1)) // 2
        return (self.av_edge_weight * num_edges + weight_sum) / (num_edges + k) \
            if (num_edges + k) > 0 else 0.0

    def add(self, entity: str, new_av_edge_weight: float) -> None:
        self.members.append(entity)
        self.av_edge_weight = new_av_edge_weight

    def to_line(self, delim: str = ",") -> str:
        return delim.join([self.id] + self.members +
                          [f"{self.av_edge_weight:.6f}"])


def agglomerative_cluster(entity_ids: Sequence[str],
                          store: EntityDistanceStore,
                          min_av_edge_weight: float,
                          dist_scale: Optional[float] = None
                          ) -> List[EdgeWeightedCluster]:
    """Greedy single pass (reference AgglomerativeGraphical.GraphMapper.map):
    join the best-improving cluster if it clears the threshold, else seed a
    new singleton cluster (the reference seeds an *empty* cluster and drops
    the entity — an apparent bug we do not reproduce)."""
    clusters: List[EdgeWeightedCluster] = []
    for ent in entity_ids:
        best, best_w = None, -np.inf
        for c in clusters:
            w = c.try_membership(ent, store)
            if w > best_w:
                best_w, best = w, c
        if best is not None and best_w > min_av_edge_weight:
            best.add(ent, best_w)
        else:
            c = EdgeWeightedCluster(dist_scale)
            c.add(ent, 0.0)
            clusters.append(c)
    return clusters
