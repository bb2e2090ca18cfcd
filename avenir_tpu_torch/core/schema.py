"""Feature schema: JSON metadata describing a CSV dataset.

Equivalent surface of chombo's ``FeatureSchema`` / ``FeatureField`` as used by the
reference (SURVEY.md §2.9; e.g. /root/reference resource/call_hangup.json,
bayesian/BayesianDistribution.java:117-123).  The JSON format is preserved
bit-for-bit so existing schema files drive the new framework unchanged:

    {"fields": [
        {"name": "id", "ordinal": 0, "id": true, "dataType": "string"},
        {"name": "issue", "ordinal": 3, "dataType": "categorical", "feature": true,
         "maxSplit": 2, "cardinality": ["internet", "cable", "billing", "other"]},
        {"name": "hold time", "ordinal": 5, "dataType": "int", "feature": true,
         "bucketWidth": 60, "min": 0, "max": 600, "splitScanInterval": 60},
        {"name": "hungup", "ordinal": 6, "dataType": "categorical"}]}

Semantics (matching the reference):
  * ``feature: true``  -> predictor attribute
  * ``id: true``       -> record identifier (kept host-side, never on device)
  * the class attribute is the field that is neither feature nor id and is
    categorical (chombo FeatureSchema.findClassAttrField behaviour).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional


NUMERIC_TYPES = ("int", "long", "double", "float")


@dataclass
class FeatureField:
    """One column of the dataset, as declared in the schema JSON."""

    name: str
    ordinal: int
    data_type: str = "string"
    feature: bool = False
    id_field: bool = False
    class_field: bool = False
    cardinality: Optional[List[str]] = None
    min: Optional[float] = None
    max: Optional[float] = None
    bucket_width: Optional[float] = None
    max_split: Optional[int] = None
    split_scan_interval: Optional[float] = None
    # free-form extras kept for forward compatibility with reference schemas
    extras: Dict[str, Any] = dc_field(default_factory=dict)

    # ---- type predicates (FeatureField.isCategorical etc. in chombo) ----
    @property
    def is_categorical(self) -> bool:
        return self.data_type == "categorical"

    @property
    def is_numeric(self) -> bool:
        return self.data_type in NUMERIC_TYPES

    @property
    def is_integer(self) -> bool:
        return self.data_type in ("int", "long")

    @property
    def is_double(self) -> bool:
        return self.data_type in ("double", "float")

    @property
    def is_text(self) -> bool:
        return self.data_type == "text"

    @property
    def is_binned(self) -> bool:
        """Categorical, or numeric with a bucketWidth: has a finite bin alphabet."""
        return self.is_categorical or self.bucket_width is not None

    @property
    def num_bins(self) -> int:
        """Size of the bin alphabet for a binned field.

        For categorical: len(cardinality).  For bucketed numeric: number of
        ``value // bucketWidth`` bins covering [min, max] (reference binning:
        bayesian/BayesianDistribution.java:152 ``bin = value / bucketWidth``).
        """
        if self.is_categorical:
            if not self.cardinality:
                raise ValueError(f"field {self.name!r}: categorical without cardinality")
            return len(self.cardinality)
        if self.bucket_width is None:
            raise ValueError(f"field {self.name!r} is not binned")
        if self.min is None or self.max is None:
            raise ValueError(f"field {self.name!r}: bucketWidth without min/max")
        return int(self.max // self.bucket_width) - int(self.min // self.bucket_width) + 1

    @property
    def bin_offset(self) -> int:
        """First bin id = min // bucketWidth (so codes start at 0 after subtracting)."""
        if self.bucket_width is None or self.min is None:
            return 0
        return int(self.min // self.bucket_width)

    def cat_code(self, value: str) -> int:
        """Vocabulary code of a categorical value (-1 if unknown)."""
        try:
            return self.cardinality.index(value)  # type: ignore[union-attr]
        except (ValueError, AttributeError):
            return -1

    def must_cat_code(self, value: str) -> int:
        """Vocabulary code of a categorical value; raises on unknown — for
        config-supplied values (e.g. positive.class.value) where a typo must
        not silently become an impossible code of -1."""
        code = self.cat_code(value)
        if code < 0:
            raise ValueError(
                f"value {value!r} not in cardinality {self.cardinality!r} "
                f"of field {self.name!r}")
        return code

    def bin_label(self, code: int) -> str:
        """Inverse of encoding: the bin string the reference would emit."""
        if self.is_categorical:
            return self.cardinality[code]  # type: ignore[index]
        return str(code + self.bin_offset)


@dataclass
class FeatureSchema:
    """The parsed schema file: ordered fields plus convenience accessors."""

    fields: List[FeatureField]

    # ---- constructors ----
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FeatureSchema":
        fields = []
        for fd in d.get("fields", []):
            known = {
                "name": fd.get("name", ""),
                "ordinal": int(fd["ordinal"]),
                "data_type": fd.get("dataType", "string"),
                "feature": bool(fd.get("feature", False)),
                "id_field": bool(fd.get("id", False)),
                "class_field": bool(fd.get("classAttr", False)),
                "cardinality": fd.get("cardinality"),
                "min": fd.get("min"),
                "max": fd.get("max"),
                "bucket_width": fd.get("bucketWidth"),
                "max_split": fd.get("maxSplit"),
                "split_scan_interval": fd.get("splitScanInterval"),
            }
            consumed = {"name", "ordinal", "dataType", "feature", "id", "classAttr",
                        "cardinality", "min", "max", "bucketWidth", "maxSplit",
                        "splitScanInterval"}
            extras = {k: v for k, v in fd.items() if k not in consumed}
            if known["cardinality"] is not None:
                known["cardinality"] = [str(c) for c in known["cardinality"]]
            fields.append(FeatureField(extras=extras, **known))
        fields.sort(key=lambda f: f.ordinal)
        return cls(fields=fields)

    def to_dict(self) -> Dict[str, Any]:
        """Inverse of :meth:`from_dict` (reference JSON key names), so a
        schema can travel inside a model artifact (serving registry) and
        reconstruct identically: ``from_dict(s.to_dict()) == s``."""
        out = []
        for f in self.fields:
            d: Dict[str, Any] = {"name": f.name, "ordinal": f.ordinal,
                                 "dataType": f.data_type}
            if f.feature:
                d["feature"] = True
            if f.id_field:
                d["id"] = True
            if f.class_field:
                d["classAttr"] = True
            for key, v in (("cardinality", f.cardinality), ("min", f.min),
                           ("max", f.max), ("bucketWidth", f.bucket_width),
                           ("maxSplit", f.max_split),
                           ("splitScanInterval", f.split_scan_interval)):
                if v is not None:
                    d[key] = v
            d.update(f.extras)
            out.append(d)
        return {"fields": out}

    @classmethod
    def from_json(cls, text: str) -> "FeatureSchema":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "FeatureSchema":
        with open(path, "r") as fh:
            return cls.from_json(fh.read())

    # ---- accessors (mirroring chombo FeatureSchema methods) ----
    def find_field_by_ordinal(self, ordinal: int) -> FeatureField:
        for f in self.fields:
            if f.ordinal == ordinal:
                return f
        raise KeyError(f"no field with ordinal {ordinal}")

    @property
    def feature_fields(self) -> List[FeatureField]:
        """getFeatureAttrFields(): fields flagged feature=true, ordinal order."""
        return [f for f in self.fields if f.feature]

    @property
    def id_fields(self) -> List[FeatureField]:
        return [f for f in self.fields if f.id_field]

    @property
    def class_attr_field(self) -> FeatureField:
        """findClassAttrField(): explicitly flagged, else the categorical field
        that is neither a feature nor an id (reference schemas rely on this,
        e.g. 'hungup' in call_hangup.json / 'status' in churn.json)."""
        for f in self.fields:
            if f.class_field:
                return f
        for f in self.fields:
            if f.is_categorical and not f.feature and not f.id_field:
                return f
        raise ValueError("schema has no class attribute field")

    @property
    def num_columns(self) -> int:
        return max(f.ordinal for f in self.fields) + 1

    def feature_ordinals(self) -> List[int]:
        return [f.ordinal for f in self.feature_fields]
