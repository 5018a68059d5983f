"""Frame — columnar table, trimmed to the port's first slice.

A copy of the construction, column-access, column-assignment, row-take,
`rbind`, `split_frame` and `asfactor` parts of `h2o3_tpu/frame/frame.py`, with the
same semantics.
Columns are host numpy (`Vec`); the algorithms move what they need to the
device. The munging surface (Rapids, group-by, string ops, parsing) is not
ported yet: ROADMAP queue A, item 11.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np

from .vec import Vec

_key_counter = itertools.count()


class Frame:
    def __init__(self, vecs: Optional[Dict[str, Vec]] = None,
                 key: Optional[str] = None):
        vecs = dict(vecs or {})
        if not all(isinstance(v, Vec) for v in vecs.values()):
            raise TypeError("Frame takes a dict of Vec; use Frame.from_numpy "
                            "or Frame.from_dict for host data")
        lens = {len(v) for v in vecs.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged frame: column lengths {lens}")
        self._vecs: Dict[str, Vec] = vecs
        self.key = key or f"frame_{next(_key_counter)}"

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_numpy(
        arr: np.ndarray,
        names: Optional[Sequence[str]] = None,
        column_types: Optional[Dict[str, str]] = None,
    ) -> "Frame":
        arr = np.atleast_2d(np.asarray(arr))
        names = list(names) if names else [f"C{i+1}" for i in range(arr.shape[1])]
        column_types = column_types or {}
        return Frame(
            {n: Vec.from_numpy(arr[:, i], column_types.get(n)) for i, n in enumerate(names)}
        )

    @staticmethod
    def from_dict(d: Dict[str, Sequence], column_types: Optional[Dict[str, str]] = None) -> "Frame":
        column_types = column_types or {}
        return Frame(
            {n: Vec.from_numpy(np.asarray(c), column_types.get(n)) for n, c in d.items()}
        )

    # -- shape / metadata ---------------------------------------------------
    @property
    def names(self) -> List[str]:
        return list(self._vecs)

    @property
    def columns(self) -> List[str]:
        return self.names

    @property
    def ncol(self) -> int:
        return len(self._vecs)

    @property
    def nrow(self) -> int:
        return len(next(iter(self._vecs.values()))) if self._vecs else 0

    @property
    def shape(self):
        return (self.nrow, self.ncol)

    @property
    def types(self) -> Dict[str, str]:
        return {n: v.type for n, v in self._vecs.items()}

    def vec(self, name: str) -> Vec:
        return self._vecs[name]

    def vecs(self) -> List[Vec]:
        return list(self._vecs.values())

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, item) -> "Frame":
        # f["col"] / f[["a","b"]] -> column subset; masks / index arrays /
        # slices -> row subset
        if isinstance(item, str):
            return Frame({item: self._vecs[item]})
        if isinstance(item, (list, tuple)) and item and all(isinstance(i, str) for i in item):
            return Frame({n: self._vecs[n] for n in item})
        if isinstance(item, int):
            n = self.names[item]
            return Frame({n: self._vecs[n]})
        if isinstance(item, slice):
            return self.take(np.arange(self.nrow)[item])
        if isinstance(item, (np.ndarray, list)):
            idx = np.asarray(item)
            if idx.dtype == bool:
                idx = np.nonzero(idx)[0]
            return self.take(idx)
        raise TypeError(f"bad index {item!r}")

    def __setitem__(self, name: str, value) -> None:
        if isinstance(value, Frame):
            value = value.vecs()[0]
        if not isinstance(value, Vec):
            value = Vec.from_numpy(np.asarray(value))
        if self._vecs and len(value) != self.nrow:
            raise ValueError("length mismatch")
        self._vecs[name] = value
        self._touch()

    def _touch(self) -> None:
        """In-place mutation hook: every mutator calls this, so per-frame
        caches (the training dataset cache keyed on `_version`,
        `models/dataset_cache.py`) never serve results computed from the
        frame's previous contents."""
        self._version = getattr(self, "_version", 0) + 1

    def take(self, idx: np.ndarray) -> "Frame":
        return Frame({n: v.take(idx) for n, v in self._vecs.items()})

    # -- combination --------------------------------------------------------
    def rbind(self, other: "Frame") -> "Frame":
        return Frame.rbind_all([self, other])

    @staticmethod
    def rbind_all(frames: Sequence["Frame"]) -> "Frame":
        """Stack k frames rowwise with ONE concatenate per column. Enum
        columns take the union of the frames' domains, in order of first
        appearance, and each frame's codes are remapped into it."""
        if not frames:
            raise ValueError("rbind_all: no frames")
        first = frames[0]
        for fr in frames[1:]:
            if fr.names != first.names:
                raise ValueError("rbind: column names differ")
        out = {}
        for n in first.names:
            vs = [fr._vecs[n] for fr in frames]
            if any(v.type == "enum" for v in vs):
                dom = list(dict.fromkeys(
                    x for v in vs for x in (v.domain or [])))
                parts = []
                for v in vs:
                    dv = v.domain or []
                    remap = (np.asarray([dom.index(x) for x in dv],
                                        np.int32)
                             if dv else np.zeros(0, np.int32))
                    c = np.asarray(v.data)
                    parts.append(np.where(c >= 0,
                                          remap[np.maximum(c, 0)], -1))
                out[n] = Vec(np.concatenate(parts), "enum", domain=dom)
            elif vs[0].type == "string":
                out[n] = Vec(None, "string", strings=np.concatenate(
                    [v.to_numpy() for v in vs]))
            else:
                out[n] = Vec(
                    np.concatenate([v.to_numpy() for v in vs]),
                    vs[0].type, domain=vs[0].domain)
        return Frame(out)

    # -- split (h2o.split_frame / water.rapids AstSplitFrame) ----------------
    def split_frame(self, ratios: Sequence[float], seed: int = 1234) -> List["Frame"]:
        rng = np.random.default_rng(seed)
        u = rng.random(self.nrow)
        bounds = np.cumsum([0.0] + list(ratios) + [1.0 - sum(ratios)])
        return [self.take(np.nonzero((u >= bounds[i]) & (u < bounds[i + 1]))[0])
                for i in range(len(bounds) - 1)]

    # -- conversion ---------------------------------------------------------
    def to_numpy(self, names: Optional[Sequence[str]] = None) -> np.ndarray:
        names = list(names) if names else self.names
        return np.column_stack([self._vecs[n].numeric_np() for n in names])

    def asfactor(self, name: Optional[str] = None) -> "Frame":
        """Coerce column(s) to enum (H2OFrame.asfactor)."""
        names = [name] if name else self.names
        out = dict(self._vecs)
        for n in names:
            v = out[n]
            if v.type != "enum":
                out[n] = Vec.from_numpy(np.asarray(v.numeric_np()), "enum")
        return Frame(out)

    def __repr__(self):
        return f"Frame(key={self.key}, shape={self.shape})"
