"""Feature index maps: feature name ↔ column index.

The analogue of the reference's ``IndexMap`` / ``DefaultIndexMap``
(photon-client ``...ml.index``).  The map lives only on the host (devices
see int32 column ids exclusively) and is saved as JSON; ``save_binary``
adds the hash-sorted ``.npz`` layout that :class:`BinaryIndexMap` queries
without building a dict (the PalDB analogue), in the reference's format.

Feature names follow the reference's ``name`` + ``term`` convention
(``NameAndTerm``): the key is ``f"{name}\x01{term}"``; plain names are keys
with an empty term.  The intercept uses the reference's magic name
``(INTERCEPT)``.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, Mapping

import numpy as np

INTERCEPT_KEY = "(INTERCEPT)"
_SEP = "\x01"


def feature_key(name: str, term: str = "") -> str:
    """The reference joins Avro (name, term) pairs into one feature id."""
    return name if not term else f"{name}{_SEP}{term}"


class IndexMap(Mapping[str, int]):
    """Immutable feature-name → column-index map.

    ``index_to_name`` provides the reverse direction (model output writes
    names next to coefficients, as the reference's Avro model format does).
    """

    def __init__(self, name_to_index: dict[str, int]):
        self._forward = dict(name_to_index)
        n = len(self._forward)
        vals = sorted(self._forward.values())
        if vals and (vals[0] != 0 or vals[-1] != n - 1 or len(set(vals)) != n):
            raise ValueError("indices must be a dense permutation of 0..n-1")
        self._reverse: list[str] = [""] * n
        for k, v in self._forward.items():
            self._reverse[v] = k

    # Mapping interface -----------------------------------------------------
    def __getitem__(self, key: str) -> int:
        return self._forward[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._forward)

    def __len__(self) -> int:
        return len(self._forward)

    def get_index(self, key: str, default: int = -1) -> int:
        return self._forward.get(key, default)

    def index_to_name(self, index: int) -> str:
        return self._reverse[index]

    @property
    def intercept_index(self) -> int | None:
        idx = self._forward.get(INTERCEPT_KEY)
        return idx

    # Construction ----------------------------------------------------------
    @staticmethod
    def build(
        feature_names: Iterable[str], add_intercept: bool = False
    ) -> "IndexMap":
        """Assign dense indices in first-seen order (the reference's
        ``DefaultIndexMap`` builds from an RDD distinct + zipWithIndex)."""
        forward: dict[str, int] = {}
        for name in feature_names:
            if name not in forward:
                forward[name] = len(forward)
        if add_intercept and INTERCEPT_KEY not in forward:
            forward[INTERCEPT_KEY] = len(forward)
        return IndexMap(forward)

    # Persistence (the PalDB replacement) -----------------------------------
    def save(self, directory: str) -> None:
        """Write as JSON (name → index), as the reference package does."""
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "index_map.json"), "w") as f:
            json.dump(self._forward, f)

    @staticmethod
    def load(directory: str) -> "IndexMap":
        with open(os.path.join(directory, "index_map.json")) as f:
            return IndexMap(json.load(f))

    def save_binary(self, directory: str) -> None:
        """Hash-sorted binary layout for very wide spaces: query without
        loading all names into a Python dict."""
        os.makedirs(directory, exist_ok=True)
        names = np.array(self._reverse)
        hashes = np.array([_stable_hash(k) for k in self._reverse],
                          dtype=np.uint64)
        order = np.argsort(hashes, kind="stable")
        np.savez(
            os.path.join(directory, "index_map.npz"),
            hashes=hashes[order],
            indices=np.arange(len(names), dtype=np.int64)[order],
            names=names[order],
        )


def _stable_hash(s: str) -> int:
    """64-bit FNV-1a, stable across processes (Python's hash() is salted)."""
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class BinaryIndexMap:
    """Reader for :meth:`IndexMap.save_binary` layouts: O(log n) lookups
    over memory-mapped arrays, no dict materialization."""

    def __init__(self, directory: str):
        z = np.load(os.path.join(directory, "index_map.npz"), mmap_mode="r")
        self._hashes = z["hashes"]
        self._indices = z["indices"]
        self._names = z["names"]

    def __len__(self) -> int:
        return len(self._hashes)

    def get_index(self, key: str, default: int = -1) -> int:
        h = np.uint64(_stable_hash(key))
        lo = int(np.searchsorted(self._hashes, h, side="left"))
        # Linear probe over (rare) hash collisions.
        while lo < len(self._hashes) and self._hashes[lo] == h:
            if self._names[lo] == key:
                return int(self._indices[lo])
            lo += 1
        return default
