"""Random-access entity-distance store: the port of
``avenir_tpu/io/diststore.py`` (host code, copied; the index and data files
are byte for byte the JAX package's).  The rebuild's equivalent of the
reference's Hadoop MapFile wrapper (util/EntityDistanceMapFileAccessor.java,
used by cluster/AgglomerativeGraphical.java and EdgeWeightedCluster.java).

Same layout idea as a MapFile — a data file plus an index — without Hadoop:
``<store>/data.txt`` holds one ``key<delim>value`` line per entity and
``<store>/index.json`` maps key -> (byte offset, byte length) into the data
file, so ``read(key)`` is a seek + bounded read regardless of store size.
Values are the reference's alternating ``target,distance`` pair lists.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple


class EntityDistanceStore:
    DATA = "data.txt"
    INDEX = "index.json"

    def __init__(self, store_dir: str, delim: str = ","):
        self.store_dir = store_dir
        self.delim = delim
        self._index: Optional[Dict[str, Tuple[int, int]]] = None
        self._fh = None

    # ---- writing (EntityDistanceMapFileAccessor.write :69-92) ----
    @classmethod
    def write(cls, lines: Iterable[str], store_dir: str,
              delim: str = ",") -> "EntityDistanceStore":
        """Each input line is ``srcId<delim>target1<delim>dist1<delim>...``;
        the first field becomes the key, the remainder the stored value."""
        os.makedirs(store_dir, exist_ok=True)
        index: Dict[str, Tuple[int, int]] = {}
        data_path = os.path.join(store_dir, cls.DATA)
        with open(data_path, "wb") as fh:
            for line in lines:
                line = line.rstrip("\n")
                if not line.strip():
                    continue
                pos = line.find(delim)
                if pos < 0:
                    raise ValueError(f"no delimiter in store line {line!r}")
                key, value = line[:pos], line[pos + 1:]
                off = fh.tell()
                blob = value.encode()
                fh.write(blob + b"\n")
                index[key] = (off, len(blob))
        with open(os.path.join(store_dir, cls.INDEX), "w") as fh:
            json.dump({"delim": delim,
                       "index": {k: list(v) for k, v in index.items()}}, fh)
        return cls(store_dir, delim)

    @classmethod
    def write_from_file(cls, in_path: str, store_dir: str,
                        delim: str = ",") -> "EntityDistanceStore":
        with open(in_path, "r") as fh:
            return cls.write(fh, store_dir, delim)

    # ---- reading (EntityDistanceMapFileAccessor.read :100-132) ----
    def _load_index(self) -> Dict[str, Tuple[int, int]]:
        if self._index is None:
            with open(os.path.join(self.store_dir, self.INDEX)) as fh:
                meta = json.load(fh)
            self.delim = meta["delim"]
            self._index = {k: (v[0], v[1]) for k, v in meta["index"].items()}
        return self._index

    def _data(self):
        if self._fh is None:
            self._fh = open(os.path.join(self.store_dir, self.DATA), "rb")
        return self._fh

    def read_raw(self, key: str) -> Optional[str]:
        entry = self._load_index().get(key)
        if entry is None:
            return None
        off, length = entry
        fh = self._data()
        fh.seek(off)
        return fh.read(length).decode()

    def read(self, key: str) -> Optional[List[Tuple[str, float]]]:
        """(target entity, distance) pairs for a source entity; None if the
        key is absent (the reference returns an empty map after logging)."""
        raw = self.read_raw(key)
        if raw is None:
            return None
        items = raw.split(self.delim)
        pairs = []
        for i in range(0, len(items) - 1, 2):
            pairs.append((items[i], float(items[i + 1])))
        return pairs

    def keys(self) -> List[str]:
        return list(self._load_index().keys())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "EntityDistanceStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
