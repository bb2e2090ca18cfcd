"""Training-time feature baselines: port of ``avenir_tpu/monitor/baseline.py``
(the single-process, table-at-a-time half).

A baseline is one stacked fixed-bin count matrix over every monitored "row"
— each numeric feature (schema ``bucketWidth`` binning when the field has
one, fixed ``n_bins`` over [min, max] otherwise), each categorical feature
(frequency table keyed by the schema's cardinality, plus one trailing bin
for unknown values), and the training class distribution.  ``update``
encodes a table's monitor codes on the host and adds their bin counts into
a device float32 (R, B_max) carry in place with the bin-counts kernel
(``kernels/histogram.py`` ``bin_counts(..., out=)``, replacing the Pallas
``ops/pallas/histogram.py`` ``bin_counts``); ``finalize()`` is the only
host sync and derives per-numeric-row quantiles from the cumulative
histogram (``stats/histogram.py``).

Baselines publish into a model's registry version as a ``baseline.json`` +
``baseline.npz`` sidecar pair through ``ModelRegistry.add_sidecar``.  A
streamed training ingest feeds the builder either as a stage of its fused
chunk pipeline (:meth:`BaselineBuilder.as_stage`, one bin-counts launch a
block on the consumer's stream) or, unfused, through :func:`tee_blocks`
(one launch a block on the thread and stream that pull the blocks); the
baseline rides the same single pass either way, with the same counts.  A
run of several processes sums the shards' partial counts
(:func:`allreduce_partials`) before any process finalises.
"""

from __future__ import annotations

import io as _io
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.schema import FeatureSchema
from ..core.table import ColumnarTable
from ..kernels.dispatch import note_backend, resolve_backend
from ..kernels.histogram import bin_counts
from ..runtime import resolve_device
from ..stats.histogram import Histogram
from ..utils.tracing import fetch, note_dispatch, note_h2d

BASELINE_JSON = "baseline.json"
BASELINE_NPZ = "baseline.npz"
FORMAT_VERSION = 1

DEFAULT_NUM_BINS = 32
QUANTILE_QS = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)

NUMERIC = "numeric"
CATEGORICAL = "categorical"
CLASS = "class"
# the class row's scope in drift reports
PREDICTION_SCOPE = "__prediction__"


@dataclass
class RowSpec:
    """One monitored distribution: a feature column or the class stream.
    ``lo``/``width`` define the bin edges for numeric rows (bin b covers
    ``[lo + b*width, lo + (b+1)*width)``; values outside clamp to the edge
    bins); categorical/class rows bin by vocabulary code with the LAST bin
    reserved for unknown (-1) codes."""

    name: str
    kind: str                    # numeric | categorical | class
    ordinal: int                 # schema ordinal
    n_bins: int
    lo: float = 0.0
    width: float = 1.0
    labels: Optional[List[str]] = None   # categorical/class bin names

    def to_dict(self) -> Dict:
        d = {"name": self.name, "kind": self.kind, "ordinal": self.ordinal,
             "n_bins": self.n_bins, "lo": self.lo, "width": self.width}
        if self.labels is not None:
            d["labels"] = list(self.labels)
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "RowSpec":
        return cls(name=d["name"], kind=d["kind"], ordinal=int(d["ordinal"]),
                   n_bins=int(d["n_bins"]), lo=float(d["lo"]),
                   width=float(d["width"]), labels=d.get("labels"))


def monitor_specs(schema: FeatureSchema,
                  n_bins: int = DEFAULT_NUM_BINS) -> List[RowSpec]:
    """The monitored rows of a schema: every feature field plus the class
    distribution (always last).  Numeric fields without min/max get
    ``n_bins = 0`` here and are resolved against the first table by
    :func:`resolve_spec_bounds`."""
    specs: List[RowSpec] = []
    for f in schema.feature_fields:
        if f.is_categorical:
            card = list(f.cardinality or [])
            specs.append(RowSpec(name=f.name, kind=CATEGORICAL,
                                 ordinal=f.ordinal, n_bins=len(card) + 1,
                                 labels=card + ["__unknown__"]))
        elif f.bucket_width is not None and f.min is not None \
                and f.max is not None:
            # the schema's own binning (value // bucketWidth - offset)
            specs.append(RowSpec(name=f.name, kind=NUMERIC,
                                 ordinal=f.ordinal, n_bins=f.num_bins,
                                 lo=f.bin_offset * f.bucket_width,
                                 width=float(f.bucket_width)))
        elif f.min is not None and f.max is not None:
            lo, hi = float(f.min), float(f.max)
            width = (hi - lo) / n_bins if hi > lo else 1.0
            specs.append(RowSpec(name=f.name, kind=NUMERIC,
                                 ordinal=f.ordinal, n_bins=n_bins,
                                 lo=lo, width=width))
        else:
            specs.append(RowSpec(name=f.name, kind=NUMERIC,
                                 ordinal=f.ordinal, n_bins=0))
    cf = schema.class_attr_field
    card = list(cf.cardinality or [])
    specs.append(RowSpec(name=cf.name, kind=CLASS, ordinal=cf.ordinal,
                         n_bins=len(card) + 1,
                         labels=card + ["__unknown__"]))
    return specs


def resolve_spec_bounds(specs: Sequence[RowSpec], table: ColumnarTable,
                        n_bins: int = DEFAULT_NUM_BINS) -> None:
    """Fill the (lo, width) of unbounded numeric specs from the first
    observed table's value range, widened by one bin each side.  Mutates
    the specs in place; no-op once resolved."""
    for s in specs:
        if s.kind == NUMERIC and s.n_bins == 0:
            col = np.asarray(table.columns[s.ordinal], dtype=np.float64)
            lo = float(col.min()) if col.size else 0.0
            hi = float(col.max()) if col.size else 1.0
            width = (hi - lo) / max(n_bins - 2, 1) if hi > lo else 1.0
            s.lo, s.width, s.n_bins = lo - width, width, n_bins


def encode_monitor_codes(table: ColumnarTable, specs: Sequence[RowSpec],
                         class_codes: Optional[np.ndarray] = None
                         ) -> np.ndarray:
    """(n, R) int32 bin codes, one column per monitored row, clamped into
    each row's bin alphabet (out-of-range numerics clamp to the edge bins,
    unknown categorical codes take the trailing unknown bin).
    ``class_codes`` overrides the table's class column."""
    n = table.n_rows
    out = np.empty((n, len(specs)), dtype=np.int32)
    for j, s in enumerate(specs):
        if s.kind == NUMERIC:
            if s.n_bins == 0:
                raise ValueError(
                    f"numeric field {s.name!r} has unresolved bin bounds; "
                    f"call resolve_spec_bounds on the first chunk")
            f = table.schema.find_field_by_ordinal(s.ordinal)
            if f.bucket_width is not None and f.min is not None \
                    and f.max is not None:
                codes = np.asarray(table.binned_codes(s.ordinal))
            else:
                col = np.asarray(table.columns[s.ordinal], dtype=np.float64)
                codes = np.floor((col - s.lo) / s.width).astype(np.int64)
            out[:, j] = np.clip(codes, 0, s.n_bins - 1)
        else:  # categorical / class: code -1 (unknown) -> trailing bin
            if s.kind == CLASS and class_codes is not None:
                codes = np.asarray(class_codes)
            else:
                codes = np.asarray(table.columns[s.ordinal])
            out[:, j] = np.where(codes < 0, s.n_bins - 1,
                                 np.clip(codes, 0, s.n_bins - 1))
    return out


@dataclass
class Baseline:
    """Finalized reference profile: stacked per-row bin counts (float64
    host copy; exact — device accumulation is float32, exact below 2^24 per
    bin) plus per-numeric-row quantiles derived from the histograms."""

    specs: List[RowSpec]
    counts: np.ndarray          # (R, B_max) float64
    n_rows: int
    quantile_qs: Tuple[float, ...] = QUANTILE_QS
    quantiles: Optional[np.ndarray] = None   # (R, Q) float64, nan non-numeric

    @property
    def n_bins_max(self) -> int:
        return self.counts.shape[1]

    def row_index(self, name: str) -> int:
        for i, s in enumerate(self.specs):
            if s.name == name:
                return i
        raise KeyError(f"no monitored row named {name!r}")

    @property
    def class_row(self) -> int:
        return len(self.specs) - 1

    def class_codes_for_labels(self, labels) -> np.ndarray:
        """Map predicted class labels onto the class row's bin codes
        (unknown/ambiguous labels take the trailing unknown bin): the label
        encoding shared by the serving hook and the driftMonitor job."""
        spec = self.specs[self.class_row]
        code = {lab: i for i, lab in enumerate(spec.labels or [])}
        unknown = spec.n_bins - 1
        return np.fromiter((code.get(lab, unknown) for lab in labels),
                           dtype=np.int32, count=len(labels))

    def probabilities(self) -> np.ndarray:
        """(R, B) per-row normalized distribution (zero-total rows stay
        all-zero)."""
        totals = self.counts.sum(axis=1, keepdims=True)
        return np.divide(self.counts, np.maximum(totals, 1.0))

    # ---- sidecar serialization ----
    def to_sidecar(self) -> Dict[str, bytes]:
        """The registry sidecar pair: JSON spec + NPZ payload, as bytes."""
        meta = {
            "format_version": FORMAT_VERSION,
            "n_rows": self.n_rows,
            "quantile_qs": list(self.quantile_qs),
            "rows": [s.to_dict() for s in self.specs],
        }
        buf = _io.BytesIO()
        arrays = {"counts": np.asarray(self.counts, np.float64)}
        if self.quantiles is not None:
            arrays["quantiles"] = np.asarray(self.quantiles, np.float64)
        np.savez(buf, **arrays)
        return {BASELINE_JSON: json.dumps(meta, indent=2).encode(),
                BASELINE_NPZ: buf.getvalue()}

    @classmethod
    def from_sidecar(cls, meta_bytes: bytes, npz_bytes: bytes) -> "Baseline":
        meta = json.loads(meta_bytes.decode())
        with np.load(_io.BytesIO(npz_bytes)) as z:
            counts = z["counts"]
            quantiles = z["quantiles"] if "quantiles" in z.files else None
        return cls(specs=[RowSpec.from_dict(d) for d in meta["rows"]],
                   counts=counts, n_rows=int(meta["n_rows"]),
                   quantile_qs=tuple(meta["quantile_qs"]),
                   quantiles=quantiles)


class BaselineBuilder:
    """Accumulate the baseline on ``device`` from ColumnarTables.

    ``update(table)`` encodes the table's monitor codes on the host (a few
    clips over already-encoded columns) and adds their bin counts into the
    device carry in one bin-counts call; nothing syncs until
    ``finalize()``."""

    def __init__(self, schema: FeatureSchema,
                 n_bins: int = DEFAULT_NUM_BINS, device=None):
        self.schema = schema
        self.n_bins = n_bins
        self.specs = monitor_specs(schema, n_bins)
        self.device = resolve_device(device)
        self._counts: Optional[torch.Tensor] = None  # (R, B_max) f32, lazy
        self._n = 0
        # the CUDA stream of the last update (a streamed ingest updates on
        # its staging thread's side stream); finalize orders after it
        self._stream: Optional[torch.cuda.Stream] = None

    def _ensure_state(self):
        if self._counts is None:
            b_max = max(s.n_bins for s in self.specs)
            self._counts = torch.zeros((len(self.specs), b_max),
                                       dtype=torch.float32,
                                       device=self.device)

    def update(self, table: ColumnarTable,
               mask: Optional[np.ndarray] = None) -> "BaselineBuilder":
        resolve_spec_bounds(self.specs, table, self.n_bins)
        self._ensure_state()
        codes = encode_monitor_codes(table, self.specs)
        note_h2d(codes.nbytes)
        d_codes = torch.from_numpy(codes).to(self.device)
        m = None
        if mask is not None:
            m = torch.from_numpy(np.ascontiguousarray(mask, bool)).to(
                self.device)
        note_dispatch(site="baseline.absorb")
        note_backend("baseline.absorb", resolve_backend(self.device))
        bin_counts(d_codes, self._counts.shape[1], m, out=self._counts)
        if self._counts.is_cuda:
            self._stream = torch.cuda.current_stream(self._counts.device)
        self._n += table.n_rows if mask is None else int(np.sum(mask))
        return self

    def as_stage(self):
        """This builder as a chunk-pipeline stage (``monitor-absorb``): the
        monitor codes are encoded on the host in ``prepare`` (the float64
        clip and floor of :meth:`update`), the bin counts are one
        bin-counts launch a chunk into the stage's (R, B_max) carry, and
        ``finish`` installs the final carry here, so :meth:`finalize` and
        :func:`allreduce_partials` work unchanged.  The carry starts from a
        copy of a pre-seeded builder's counts (the retrain controller's
        resumed build re-profiles the consumed head through
        :meth:`update` first).  Counts are exact integers in float32, so a
        fused and a tee'd baseline finalise byte-identically."""
        from ..pipeline.compiler import Stage
        # an unresolved numeric spec resolves to exactly n_bins bins on the
        # first chunk, so the carry's width is known before the stream
        b_max = max([s.n_bins for s in self.specs]
                    + ([self.n_bins] if any(
                        s.kind == NUMERIC and s.n_bins == 0
                        for s in self.specs) else []))
        builder = self

        def prepare(table):
            resolve_spec_bounds(builder.specs, table, builder.n_bins)
            builder._n += table.n_rows
            codes = encode_monitor_codes(table, builder.specs)
            note_h2d(codes.nbytes)
            return {"mon_codes": codes}

        def kernel(carry, consts, inputs, upstream):
            note_backend("baseline.absorb", resolve_backend(carry.device))
            return bin_counts(inputs["mon_codes"], b_max, inputs["mask"],
                              out=carry), {}

        def carry_init():
            if builder._counts is not None:
                # a copy (read after the stream that last added to it)
                return builder.host_counts().astype(np.float32)
            return np.zeros((len(builder.specs), b_max), np.float32)

        def finish(carry):
            builder._counts = carry
            builder._stream = torch.cuda.current_stream(carry.device) \
                if carry.is_cuda else None

        # b_max fixes the kernel's bins, so it is part of the stage's key
        return Stage(name="monitor-absorb", kernel=kernel,
                     version=f"1:b{b_max}", prepare=prepare,
                     carry_init=carry_init, finish=finish)

    def host_counts(self) -> np.ndarray:
        """The (R, B_max) counts as float64 on the host.  The read-back
        waits for the stream the counts were last added on."""
        self._ensure_state()
        if self._stream is not None:
            torch.cuda.current_stream(self._counts.device).wait_stream(
                self._stream)
        return fetch(self._counts).astype(np.float64)

    def finalize(self) -> Baseline:
        """Host sync: pull the device counts once, derive quantiles."""
        counts = self.host_counts()
        quantiles = np.full((len(self.specs), len(QUANTILE_QS)), np.nan)
        for i, s in enumerate(self.specs):
            if s.kind != NUMERIC or counts[i, :s.n_bins].sum() <= 0:
                continue
            h = Histogram(s.lo, s.width, counts[i, :s.n_bins])
            quantiles[i] = [h.percentile(q) for q in QUANTILE_QS]
        return Baseline(specs=[RowSpec.from_dict(s.to_dict())
                               for s in self.specs],
                        counts=counts, n_rows=self._n, quantiles=quantiles)


def _require_bounded_numerics(schema: FeatureSchema) -> None:
    """Multi-process guard: every numeric feature's bins must be pinned by
    the schema, or each shard resolves its own edges from its first block
    and the sum of the partial counts means nothing."""
    unbounded = [f.name for f in schema.feature_fields
                 if f.is_numeric and (f.min is None or f.max is None)]
    if unbounded:
        raise ValueError(
            f"multi-process baseline needs schema min/max on every numeric "
            f"feature (bins must agree across shards); missing on: "
            f"{unbounded}")


def allreduce_partials(builder: BaselineBuilder,
                       reducer=None) -> BaselineBuilder:
    """Sum the per-shard partial counts (and row counts) so every process
    finalises the same global baseline: through ``reducer``'s allgather in
    a row-range-sharded build (either lane), through the joined run's
    allgather otherwise, and not at all in a single process.  A
    collective: every shard calls it, also one with no rows, and before
    only shard 0 publishes.  Exact: the counts are integers below 2^24 a
    cell (float32)."""
    from ..parallel.distributed import allgather_object, is_multiprocess
    if reducer is not None and reducer.spec.active:
        gather = reducer.allgather
    elif is_multiprocess():
        gather = allgather_object
    else:
        return builder
    _require_bounded_numerics(builder.schema)
    parts = gather((builder.host_counts(), builder._n))
    total = np.sum([c for c, _ in parts], axis=0).astype(np.float32)
    note_h2d(total.nbytes)
    builder._counts = torch.from_numpy(total).to(builder.device)
    builder._stream = None
    builder._n = int(sum(n for _, n in parts))
    return builder


def tee_blocks(blocks, builder: BaselineBuilder):
    """Pass-through generator: every block updates the baseline builder on
    its way to the training consumer, so the baseline costs no second pass
    over a streamed ingest."""
    for b in blocks:
        builder.update(b)
        yield b


def compute_baseline(table: ColumnarTable, n_bins: int = DEFAULT_NUM_BINS,
                     device=None) -> Baseline:
    """One-shot baseline from a fully loaded table."""
    return BaselineBuilder(table.schema, n_bins,
                           device=device).update(table).finalize()


# --------------------------------------------------------------------------
# registry integration
# --------------------------------------------------------------------------

def publish_baseline(registry, name: str, version: int,
                     baseline: Baseline) -> None:
    """Attach the baseline sidecar pair to a committed registry version
    (tmp-then-rename per file; the manifest is updated last, so a crash
    mid-write leaves the version intact and baseline-less, never torn)."""
    registry.add_sidecar(name, version, baseline.to_sidecar())


def load_baseline(registry, name: str,
                  version: Optional[int] = None) -> Baseline:
    """Read a version's baseline sidecar (newest intact version when
    ``version`` is None).  Raises FileNotFoundError when the version
    carries no baseline."""
    if version is None:
        version = registry.latest_version(name)
        if version is None:
            raise FileNotFoundError(
                f"no intact versions of model {name!r} in "
                f"{registry.base_dir!r}")
    meta_b = registry.read_sidecar(name, version, BASELINE_JSON)
    npz_b = registry.read_sidecar(name, version, BASELINE_NPZ)
    return Baseline.from_sidecar(meta_b, npz_b)
