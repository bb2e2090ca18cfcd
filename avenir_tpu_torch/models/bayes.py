"""Naive Bayes: the port of ``avenir_tpu/models/bayes.py``
(org.avenir.bayesian, SURVEY.md §7.3).

* :func:`train` == BayesianDistribution: one pass counting class priors,
  feature priors and feature posteriors.  Categorical and bucketed
  numeric features count (class, ord, bin) cells; unbucketed numeric
  features sum (count, Σx, Σx²) per class and overall, then the
  reference's integer mean and σ.
* :class:`NaiveBayesModel` ``to_lines`` / ``from_lines`` == the
  reference's model file, line for line and byte for byte.
* :func:`predict` == BayesianPredictor: per class P(x|c)·P(c)/P(x) as a
  truncated integer percent, the first maximum as the prediction.

Training runs on the device in chunks of at most ``1 << 23`` rows.  The
rows travel on the narrowest wire form their alphabets allow — two codes
a byte (the 4-bit form), one (uint8) or int32 — with the validity mask
built on the device from the chunk's valid-row count; the counts are
``bincount`` sums, exact, and read back to host float64 per chunk.  The
moments are float64 one-hot contractions: exact integers, so the model
is the same on the CPU and the card (the JAX package sums them in
float32; ``class_moments``).

Prediction must print the JAX package's integers and float32 strings,
which come from XLA's CPU float32: its ``log`` of the probability tables
and of the Gaussian scale, its ``exp`` of the log ratio (both Cephes
polynomials, :mod:`..utils.xla_math`), feature sums left to right, and
its saturating float-to-int conversion.  Every op here is a correctly
rounded float32 (or exact float64) torch op in that order, so the CPU
and a GPU give the same bits.  No Pallas kernel is on this path: the
JAX package's train and predict are plain ``jnp``.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.metrics import ConfusionMatrix, Counters
from ..core.schema import FeatureField, FeatureSchema
from ..core.table import ColumnarTable
from ..ops.histogram import _flat_count, class_bin_histogram, class_moments
from ..runtime import resolve_device
from ..utils.tracing import fetch, note_dispatch, note_h2d
from ..utils.xla_math import seq_row_sum, xla_exp_f32, xla_log_f32

CHUNK_ROWS = 1 << 23


# --------------------------------------------------------------------------
# model container
# --------------------------------------------------------------------------

@dataclass
class NaiveBayesModel:
    schema: FeatureSchema
    class_values: List[str]
    binned_ordinals: List[int]          # feature ordinals with finite bins
    cont_ordinals: List[int]            # unbucketed numeric feature ordinals
    num_bins: List[int]                 # per binned ordinal
    # counts
    post_counts: np.ndarray             # (C, Fb, Bmax) float64
    class_counts: np.ndarray            # (C,) float64 record counts
    prior_counts: np.ndarray            # (Fb, Bmax) float64
    total: float                        # total record count
    # continuous gaussian parameters, reference-rounded to integers
    cont_post_mean: np.ndarray          # (C, Fc)
    cont_post_std: np.ndarray           # (C, Fc)
    cont_prior_mean: np.ndarray         # (Fc,)
    cont_prior_std: np.ndarray          # (Fc,)

    # ---- serialization: the reference model CSV ----
    def to_lines(self, delim: str = ",") -> List[str]:
        """The reducer's line set and order: for each (class, ord, bin)
        cell in key-sort order a [posterior, class-prior, feature-prior]
        triple, then the continuous feature priors."""
        lines: List[str] = []
        # the shuffle sorts (classVal: str, ord: int, bin: str) keys; the
        # bin sorts as a string
        cells = []
        for ci, cv in enumerate(self.class_values):
            for fi, o in enumerate(self.binned_ordinals):
                field = self.schema.find_field_by_ordinal(o)
                for b in range(self.num_bins[fi]):
                    cnt = int(round(self.post_counts[ci, fi, b]))
                    if cnt > 0:
                        cells.append((cv, o, field.bin_label(b), ci, fi, b,
                                      cnt))
            for fi, o in enumerate(self.cont_ordinals):
                cells.append((cv, o, None, ci, fi, None, None))
        cells.sort(key=lambda t: (t[0], t[1], "" if t[2] is None else t[2]))
        for cv, o, bin_label, ci, fi, b, cnt in cells:
            if bin_label is not None:
                lines.append(delim.join([cv, str(o), bin_label, str(cnt)]))
                lines.append(delim.join([cv, "", "", str(cnt)]))
                lines.append(delim.join(["", str(o), bin_label, str(cnt)]))
            else:
                mean = int(self.cont_post_mean[ci, fi])
                std = int(self.cont_post_std[ci, fi])
                lines.append(delim.join([cv, str(o), "", str(mean),
                                         str(std)]))
                ccount = int(round(self.class_counts[ci]))
                lines.append(delim.join([cv, "", "", str(ccount)]))
        for fi, o in enumerate(self.cont_ordinals):
            mean = int(self.cont_prior_mean[fi])
            std = int(self.cont_prior_std[fi])
            lines.append(delim.join(["", str(o), "", str(mean), str(std)]))
        return lines

    @classmethod
    def from_lines(cls, lines: Sequence[str], schema: FeatureSchema,
                   delim: str = ",") -> "NaiveBayesModel":
        """Parse the reference model CSV (BayesianPredictor.loadModel:
        duplicate bin lines accumulate)."""
        class_values = list(schema.class_attr_field.cardinality or [])
        binned = [f for f in schema.feature_fields if f.is_binned]
        cont = [f for f in schema.feature_fields if not f.is_binned]
        b_ords = [f.ordinal for f in binned]
        c_ords = [f.ordinal for f in cont]
        nbins = [f.num_bins for f in binned]
        bmax = max(nbins) if nbins else 1
        C, Fb, Fc = len(class_values), len(b_ords), len(c_ords)
        post = np.zeros((C, Fb, bmax))
        prior = np.zeros((Fb, bmax))
        cls_counts = np.zeros((C,))
        cpm = np.zeros((C, Fc))
        cps = np.ones((C, Fc))
        cqm = np.zeros((Fc,))
        cqs = np.ones((Fc,))
        b_index = {o: i for i, o in enumerate(b_ords)}
        c_index = {o: i for i, o in enumerate(c_ords)}
        cls_index = {v: i for i, v in enumerate(class_values)}

        def bin_code(field: FeatureField, label: str) -> int:
            if field.is_categorical:
                return field.cat_code(label)
            return int(label) - field.bin_offset

        for line in lines:
            items = line.split(delim)
            ord_s = items[1]
            if items[0] == "":
                if items[2] != "":       # feature prior, binned
                    f = schema.find_field_by_ordinal(int(ord_s))
                    prior[b_index[int(ord_s)], bin_code(f, items[2])] += \
                        int(items[3])
                else:                     # feature prior, continuous
                    ci2 = c_index[int(ord_s)]
                    cqm[ci2] = float(items[3])
                    cqs[ci2] = float(items[4])
            elif ord_s == "" and items[2] == "":  # class prior
                cls_counts[cls_index[items[0]]] += int(items[3])
            else:
                ci = cls_index[items[0]]
                f = schema.find_field_by_ordinal(int(ord_s))
                if items[2] != "":        # posterior, binned
                    post[ci, b_index[int(ord_s)], bin_code(f, items[2])] += \
                        int(items[3])
                else:                     # posterior, continuous
                    fi2 = c_index[int(ord_s)]
                    cpm[ci, fi2] = float(items[3])
                    cps[ci, fi2] = float(items[4])
        # a class prior line is emitted once a (class, ord, bin) cell, each
        # carrying that cell's count: the accumulated value is (Fb + Fc)
        # times the class's record count
        cls_counts = cls_counts / max(Fb + Fc, 1)
        return cls(schema=schema, class_values=class_values,
                   binned_ordinals=b_ords, cont_ordinals=c_ords,
                   num_bins=nbins, post_counts=post, class_counts=cls_counts,
                   prior_counts=prior, total=float(cls_counts.sum()),
                   cont_post_mean=cpm, cont_post_std=cps,
                   cont_prior_mean=cqm, cont_prior_std=cqs)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def wire_pack4_fits(schema: FeatureSchema) -> bool:
    """True when every alphabet fits a nibble with 15 left as the
    out-of-alphabet sentinel: the 4-bit wire form's gate."""
    C = len(schema.class_attr_field.cardinality or [])
    bmax = max((f.num_bins for f in schema.feature_fields if f.is_binned),
               default=1)
    return C <= 15 and bmax <= 15


def _pack4_wanted(fits: bool, device: torch.device) -> bool:
    """The 4-bit wire's auto rule: pack only where a host-to-device link
    exists to win back the host nibble pass (not on the CPU);
    ``AVENIR_TPU_WIRE_PACK4=1/0`` forces either form."""
    env = os.environ.get("AVENIR_TPU_WIRE_PACK4", "auto")
    return fits and env != "0" and (env == "1" or device.type != "cpu")


def _unpack4(pk: torch.Tensor, F: int) -> torch.Tensor:
    """The 4-bit wire matrix -> (n, F) int64 codes: byte j carries code 2j
    in its high nibble and code 2j+1 in its low nibble; a trailing nibble
    of an odd F is dropped."""
    pk = pk.long()
    both = torch.stack([pk >> 4, pk & 15], dim=2)
    return both.reshape(pk.shape[0], -1)[:, :F]


def _narrow(codes: np.ndarray, alphabet: int) -> np.ndarray:
    """uint8 wire form when the alphabet fits: codes outside
    [0, alphabet) map to the 255 sentinel, which the counts drop; int32
    otherwise."""
    codes = np.asarray(codes)
    if alphabet <= 255:
        return np.where((codes >= 0) & (codes < alphabet),
                        codes, 255).astype(np.uint8)
    return codes.astype(np.int32)


def _narrow4(codes: np.ndarray, alphabet: int) -> np.ndarray:
    codes = np.asarray(codes)
    return np.where((codes >= 0) & (codes < alphabet), codes,
                    15).astype(np.uint8)


def _train_chunk(cc: torch.Tensor, bc: torch.Tensor, cv: torch.Tensor,
                 k: int, C: int, bmax: int):
    """One chunk on its device: the first ``k`` rows are valid (the mask
    is built on the device from the scalar); returns the float32 (C, Fb,
    Bmax) counts, the (C,) class counts and the float64 (C, Fc, 3)
    moments."""
    m = torch.arange(cc.shape[0], device=cc.device) < k
    counts = class_bin_histogram(cc, bc, C, bmax, m)
    c = cc.long()
    cls_counts = _flat_count(c, m & (c >= 0) & (c < C), C, torch.float32)
    moments = class_moments(cc, cv, C, m, dtype=torch.float64)
    return counts, cls_counts, moments


def _gauss(mom: np.ndarray):
    """The reference's integer Gaussian: mean = Σx / n integer-divided,
    std = floor(sqrt((Σx² - n·mean²) / (n - 1)))."""
    cnt = np.maximum(mom[..., 0], 1.0)
    mean = np.floor(mom[..., 1] / cnt)
    var = (mom[..., 2] - cnt * mean * mean) / np.maximum(cnt - 1.0, 1.0)
    std = np.floor(np.sqrt(np.maximum(var, 0.0)))
    return mean, std


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(table: ColumnarTable, device=None,
          counters: Optional[Counters] = None,
          chunk_rows: int = CHUNK_ROWS, reducer=None,
          stats: Optional[dict] = None, mesh=None) -> NaiveBayesModel:
    """One-pass distribution computation (== the BayesianDistribution job)
    on ``device`` (default: the process device, ``cuda`` unless asked
    otherwise).

    Rows go to the device in chunks of ``chunk_rows`` (at most 1 << 23:
    the float32 counts of a chunk stay below 2^24 a cell, so exact), into
    one device buffer of the chunk's shape reused for every chunk; the
    chunk's counts are read back and accumulated in host float64.

    ``mesh`` (a ``parallel.mesh.DeviceMesh``, in place of ``device``)
    splits each chunk's rows over its devices, the JAX package's
    ``ctx.shard_rows``: each device counts one contiguous slice into its
    own buffers, and the integer counts and moments are summed on the
    host, so the model is the one-device model byte for byte.  A mesh may
    name one device several times (``["cuda:0"] * 4``).

    ``reducer`` (a ``parallel.collectives.AllReducer``; a joined run over
    per-process files): the row counts are gathered once to agree the
    chunk shape on the largest local count, and one sum of the float64
    counts, class counts and moments makes every process's model that of
    one process over the concatenated inputs.

    ``stats``, when given, receives the seconds of each layer:
    ``pack_s`` (host wire pack), ``h2d_s``, ``hist_s`` (device counts,
    synchronised), ``d2h_s`` and ``reduce_s``."""
    if chunk_rows > CHUNK_ROWS:
        raise ValueError(
            f"chunk_rows={chunk_rows} exceeds 1<<23: a chunk's float32 "
            f"counts are exact only below 2^24 a cell, which chunks of at "
            f"most 8M rows guarantee")
    devs = list(mesh.devices) if mesh is not None \
        else [resolve_device(device)]
    dev = devs[0]
    schema = table.schema
    class_field = schema.class_attr_field
    class_values = list(class_field.cardinality or [])
    C = len(class_values)
    binned = [f for f in schema.feature_fields if f.is_binned]
    cont = [f for f in schema.feature_fields if not f.is_binned]
    nbins = [f.num_bins for f in binned]
    bmax = max(nbins) if nbins else 1
    Fb, Fc = len(binned), len(cont)
    n = table.n_rows
    t0 = time.perf_counter()

    fits4 = wire_pack4_fits(schema)
    pack4 = _pack4_wanted(fits4, dev)
    if os.environ.get("AVENIR_TPU_WIRE_PACK4") == "1" and not fits4:
        warnings.warn(
            f"AVENIR_TPU_WIRE_PACK4=1 ignored: alphabets don't fit a "
            f"nibble (C={C}, bmax={bmax}); using the uint8 wire form")
    F_packed = 1 + Fb
    # one host wire matrix a form, filled a column at a time
    if pack4:
        cols = [(table.columns[class_field.ordinal], C)]
        cols += [(table.binned_codes(f.ordinal), bmax) for f in binned]
        wires = [np.zeros((n, (F_packed + 1) // 2), dtype=np.uint8)]
        for j, (codes, alphabet) in enumerate(cols):
            col = _narrow4(codes, alphabet)
            wires[0][:, j // 2] |= (col << 4) if j % 2 == 0 else col
    else:
        cls_host = _narrow(table.columns[class_field.ordinal], C)
        bin_host = np.empty((n, Fb),
                            dtype=np.uint8 if bmax <= 255 else np.int32)
        for j, f in enumerate(binned):
            bin_host[:, j] = _narrow(table.binned_codes(f.ordinal), bmax)
        wires = [cls_host, bin_host]
    # the reference parses continuous values as integers (long)
    cont_host = np.empty((n, Fc), dtype=np.float32)
    for j, f in enumerate(cont):
        cont_host[:, j] = np.trunc(table.columns[f.ordinal])
    wires.append(cont_host)
    t1 = time.perf_counter()

    # every process runs the chunk shape of the largest local row count;
    # the buffers start zeroed, so rows past a short chunk's valid count
    # hold finite values (the mask zeroes their one-hot, not a NaN's sum)
    n_goal = max(reducer.allgather(n)) if reducer is not None else n
    chunk = max(1, min(chunk_rows, n_goal))
    # a chunk splits into one contiguous slice a mesh device
    part = -(-chunk // len(devs))
    bufs = [[torch.zeros((part,) + w.shape[1:], dtype=torch.from_numpy(
        w[:0]).dtype, device=d) for w in wires] for d in devs]
    counts = np.zeros((C, Fb, bmax), dtype=np.float64)
    cls_counts = np.zeros((C,), dtype=np.float64)
    moments = np.zeros((C, Fc, 3), dtype=np.float64)
    h2d = hist = d2h = 0.0
    for lo in range(0, n, chunk):
        e = min(lo + chunk, n)
        slices = [(b, a, min(a + part, e)) for b, a in
                  zip(bufs, range(lo, e, part))]
        ta = time.perf_counter()
        for sb, a, b in slices:
            for buf, w in zip(sb, wires):
                buf[:b - a].copy_(torch.from_numpy(w[a:b]))
                note_h2d(w[a:b].nbytes)
        if stats is not None:
            for d in devs:
                _sync(d)
        tb = time.perf_counter()
        parts = []
        for sb, a, b in slices:
            if pack4:
                codes = _unpack4(sb[0], F_packed)
                cc, bc = codes[:, 0], codes[:, 1:]
            else:
                cc, bc = sb[0], sb[1]
            parts.append(_train_chunk(cc, bc, sb[-1], b - a, C, bmax))
        note_dispatch(site="bayes.train")
        if stats is not None:
            for d in devs:
                _sync(d)
        tc = time.perf_counter()
        for c_, cl_, mo_ in parts:
            counts += fetch(c_).astype(np.float64)
            cls_counts += fetch(cl_).astype(np.float64)
            moments += fetch(mo_)
        td = time.perf_counter()
        h2d += tb - ta
        hist += tc - tb
        d2h += td - tc
    t2 = time.perf_counter()
    if reducer is not None:
        flat = reducer.sum(np.concatenate(
            [counts.ravel(), cls_counts, moments.ravel()]))
        counts = flat[:counts.size].reshape(counts.shape)
        cls_counts = flat[counts.size:counts.size + C]
        moments = flat[counts.size + C:].reshape(moments.shape)
    if stats is not None:
        stats.update(pack_s=t1 - t0, h2d_s=h2d, hist_s=hist, d2h_s=d2h,
                     reduce_s=time.perf_counter() - t2)

    # bins past a field's own alphabet (the Bmax padding) hold nothing
    for fi, nb in enumerate(nbins):
        counts[:, fi, nb:] = 0.0
    prior = counts.sum(axis=0)
    cpm, cps = _gauss(moments)                      # (C, Fc)
    cqm, cqs = _gauss(moments.sum(axis=0))          # (Fc,)

    if counters is not None:
        counters.increment("Distribution Data", "Feature posterior binned ",
                           int((counts > 0).sum()))
        counters.increment("Distribution Data", "Class prior", C)

    return NaiveBayesModel(
        schema=schema, class_values=class_values,
        binned_ordinals=[f.ordinal for f in binned],
        cont_ordinals=[f.ordinal for f in cont], num_bins=nbins,
        post_counts=counts, class_counts=cls_counts, prior_counts=prior,
        total=float(cls_counts.sum()),
        cont_post_mean=cpm, cont_post_std=cps,
        cont_prior_mean=cqm, cont_prior_std=cqs)


# --------------------------------------------------------------------------
# prediction
# --------------------------------------------------------------------------

class PredictionResult:
    """Per-record prediction outputs.  ``pred_class``, ``pred_prob`` and
    ``class_prob_diff`` are read back with the prediction; ``class_probs``
    ((n, C) int percents, the cost arbitration), ``feature_prior_prob``
    (P(x)) and ``feature_post_prob`` (P(x|c)), the feature-prob-only
    mode's, stay on the device until first read."""

    def __init__(self, pred_class: List[str], pred_prob: np.ndarray,
                 class_probs=None,
                 class_prob_diff: Optional[np.ndarray] = None,
                 feature_prior_prob=None, feature_post_prob=None,
                 n_rows: Optional[int] = None):
        self.pred_class = pred_class            # per record
        self.pred_prob = pred_prob              # (n,) int percent
        self.class_prob_diff = class_prob_diff
        self._pct = class_probs                 # (n, C) int, maybe device
        self._px = feature_prior_prob           # (n,) P(x), maybe device
        self._pxc = feature_post_prob           # (n, C) P(x|c), maybe device
        self._n = n_rows if n_rows is not None else len(pred_class)

    def _fetch(self, attr):
        v = getattr(self, attr)
        if v is not None and not isinstance(v, np.ndarray):
            v = fetch(v)[:self._n]
            setattr(self, attr, v)
        return v

    @property
    def class_probs(self) -> Optional[np.ndarray]:
        return self._fetch("_pct")

    @property
    def feature_prior_prob(self) -> Optional[np.ndarray]:
        return self._fetch("_px")

    @property
    def feature_post_prob(self) -> Optional[np.ndarray]:
        return self._fetch("_pxc")


_LOG_EPS = float(np.float32(1e-30))
_SQRT_2PI = float(np.float32(np.sqrt(2 * np.pi)))
_I32_MIN, _I32_MAX = -2.0 ** 31, 2.0 ** 31 - 1


def _gauss_log(x: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor
               ) -> torch.Tensor:
    """float32 ``-0.5*((x - mu)/sd)**2 - log(sd*sqrt(2π))`` as XLA
    computes it: the quotient correctly rounded (in float64, which rounds
    to the float32 quotient), XLA's log of the scale."""
    t = ((x - mu).double() / sd.double()).float()
    return (t * t) * -0.5 - xla_log_f32(sd * _SQRT_2PI)


def _predict_body(bci: torch.Tensor, unknown: torch.Tensor,
                  cv: torch.Tensor, tables):
    """The JAX package's ``_predict_body`` in float32 torch ops: returns
    the (n, C) int32 percents, the (3, n) int32 [argmax, max, top-2 diff],
    P(x) (n,) and P(x|c) (n, C)."""
    (log_post, log_prior, log_class, cpm, cps, cqm, cqs, nbins) = tables
    C, Fb, bmax = log_post.shape
    n = bci.shape[0]
    dev = bci.device
    safe = bci.long().clamp(0, bmax - 1)                    # (n, Fb)
    # an unknown categorical or out-of-alphabet bin skips the feature: it
    # enters neither P(x|c) nor P(x)
    known = ~unknown & (bci.long() < nbins[None, :Fb])
    f_idx = torch.arange(Fb, device=dev)[None, :].expand(n, Fb)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lp_post = torch.where(known[:, None, :],
                          log_post[:, f_idx, safe].permute(1, 0, 2), zero)
    lp_prior = torch.where(known, log_prior[f_idx, safe], zero)
    # Gaussian log densities of the continuous features
    lg_post = _gauss_log(cv[:, None, :], cpm[None], cps[None])  # (n, C, Fc)
    lg_prior = _gauss_log(cv, cqm[None], cqs[None])             # (n, Fc)
    log_px_c = seq_row_sum(lp_post) + seq_row_sum(lg_post)      # (n, C)
    log_px = seq_row_sum(lp_prior) + seq_row_sum(lg_prior)      # (n,)
    log_ratio = (log_px_c + log_class[None]) - log_px[:, None]
    pct = torch.floor(xla_exp_f32(log_ratio) * 100.0)
    # XLA's float -> int32 conversion saturates, NaN -> 0
    pct = torch.nan_to_num(pct.double(), nan=0.0).clamp(
        _I32_MIN, _I32_MAX).to(torch.int32)
    best = torch.argmax(pct, dim=1).to(torch.int32)         # first max
    top2 = torch.topk(pct, min(2, C), dim=1).values
    pred_prob = top2[:, 0]
    diff = top2[:, 0] - top2[:, 1] if C > 1 \
        else torch.full((n,), 100, dtype=torch.int32, device=dev)
    return (pct, torch.stack([best, pred_prob, diff]),
            xla_exp_f32(log_px), xla_exp_f32(log_px_c))


def _device_model_tables(model: NaiveBayesModel, device: torch.device):
    """The model's probability tables on ``device``: the eight small
    arrays packed into one float32 upload, cut on the device, the logs
    taken there (XLA's float32 log, as the JAX package takes them on its
    device), and cached on the model per device."""
    cached = model.__dict__.get("_dev_tables")
    if cached is not None and cached[0] == device:
        return cached[1]
    post_p = (model.post_counts / np.maximum(
        model.class_counts[:, None, None], 1.0)).astype(np.float32)
    prior_p = (model.prior_counts / max(model.total, 1.0)).astype(np.float32)
    class_p = (model.class_counts / max(model.total, 1.0)).astype(np.float32)
    cpm = np.asarray(model.cont_post_mean, dtype=np.float32)
    cps = np.maximum(model.cont_post_std, 1e-6).astype(np.float32)
    cqm = np.asarray(model.cont_prior_mean, dtype=np.float32)
    cqs = np.maximum(model.cont_prior_std, 1e-6).astype(np.float32)
    nbins = np.asarray(model.num_bins if model.num_bins else [1],
                       dtype=np.float32)   # small ints, exact in float32
    parts = [post_p, prior_p, class_p, cpm, cps, cqm, cqs, nbins]
    packed_host = np.concatenate([p.ravel() for p in parts])
    note_h2d(packed_host.nbytes)
    packed = torch.from_numpy(packed_host).to(device)
    arrays = []
    off = 0
    for p in parts:
        arrays.append(packed[off:off + p.size].reshape(p.shape))
        off += p.size

    def log(x):
        return xla_log_f32(torch.clamp(x, min=_LOG_EPS))

    tables = (log(arrays[0]), log(arrays[1]), log(arrays[2]),
              arrays[3], arrays[4], arrays[5], arrays[6],
              torch.round(arrays[7]).to(torch.int64))
    model.__dict__["_dev_tables"] = (device, tables)
    return tables


def predict(model: NaiveBayesModel, table: ColumnarTable,
            device=None, stats: Optional[dict] = None) -> PredictionResult:
    """Per-record class posterior integer percents
    (BayesianPredictor.predictClassValue): ``(int)(P(x|c)·P(c)/P(x)·100)``
    with P(x|c) the product of post[c, f, bin_f] / classCount_c (a
    Gaussian density for a continuous feature), P(x) the product of
    prior[f, bin_f] / total.

    The codes travel on the 4-bit wire when every bin alphabet fits a
    nibble (the train rule), else uint8 below 255 bins, else int32.  Unlike
    train, any code in [0, sentinel) is kept and a code past its field's
    alphabet is dropped on the device by the per-field bin count, so a far
    out-of-range value cannot wrap into a valid bin.

    ``stats``, when given, receives the seconds of each layer: ``pack_s``
    (host wire pack), ``upload_s`` (the model tables on a first call, the
    wire's H2D), ``score_s`` (synchronised) and ``readback_s``."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    schema = model.schema
    binned_fields = [schema.find_field_by_ordinal(o)
                     for o in model.binned_ordinals]
    cont_fields = [schema.find_field_by_ordinal(o)
                   for o in model.cont_ordinals]
    n = table.n_rows
    Fb = len(binned_fields)
    max_bins = max(model.num_bins) if model.num_bins else 0
    u8 = max_bins < 255
    pack4 = _pack4_wanted(max_bins <= 15, dev)
    if pack4:
        wire = np.zeros((n, (Fb + 1) // 2), dtype=np.uint8)
        for j, f in enumerate(binned_fields):
            codes = table.binned_codes(f.ordinal)
            col = np.where((codes < 0) | (codes >= 15), 15,
                           codes).astype(np.uint8)
            wire[:, j // 2] |= (col << 4) if j % 2 == 0 else col
    else:
        wire = np.empty((n, Fb), dtype=np.uint8 if u8 else np.int32)
        for j, f in enumerate(binned_fields):
            codes = table.binned_codes(f.ordinal)
            if u8:
                codes = np.where((codes < 0) | (codes >= 255), 255, codes)
            wire[:, j] = codes
    cont_vals = np.empty((n, len(cont_fields)), dtype=np.float32)
    for j, f in enumerate(cont_fields):
        # the reference parses continuous values as integers (long)
        cont_vals[:, j] = np.trunc(table.columns[f.ordinal])
    t1 = time.perf_counter()
    tables = _device_model_tables(model, dev)
    note_h2d(wire.nbytes + cont_vals.nbytes, transfers=2)
    wire_d = torch.from_numpy(wire).to(dev)
    cv = torch.from_numpy(cont_vals).to(dev)
    if stats is not None:
        _sync(dev)
    t2 = time.perf_counter()
    if pack4:
        bci = _unpack4(wire_d, Fb)
        unknown = bci == 15
    elif u8:
        bci = wire_d.long()
        unknown = bci == 255
    else:
        bci = wire_d.long()
        unknown = bci < 0
    pct, eager, px, pxc = _predict_body(bci, unknown, cv, tables)
    note_dispatch(site="bayes.predict")
    if stats is not None:
        _sync(dev)
    t3 = time.perf_counter()
    best, pred_prob, diff = fetch(eager)
    if stats is not None:
        stats.update(pack_s=t1 - t0, upload_s=t2 - t1, score_s=t3 - t2,
                     readback_s=time.perf_counter() - t3)
    return PredictionResult(
        pred_class=[model.class_values[i] for i in best],
        pred_prob=pred_prob, class_probs=pct, class_prob_diff=diff,
        feature_prior_prob=px, feature_post_prob=pxc, n_rows=n)


def evaluate(model: NaiveBayesModel, table: ColumnarTable,
             result: PredictionResult,
             neg_class: Optional[str] = None, pos_class: Optional[str] = None,
             counters: Optional[Counters] = None) -> ConfusionMatrix:
    """The validation confusion matrix (BayesianPredictor.cleanup)."""
    if neg_class is None or pos_class is None:
        neg_class, pos_class = model.class_values[0], model.class_values[1]
    cm = ConfusionMatrix(neg_class, pos_class)
    actual = [model.class_values[c] if c >= 0 else "?"
              for c in table.class_codes()]
    for p, a in zip(result.pred_class, actual):
        cm.report(p, a)
    if counters is not None:
        cm.export(counters)
    return cm
