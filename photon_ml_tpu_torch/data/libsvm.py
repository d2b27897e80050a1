"""LIBSVM-format ingest (host side).

The reference's driver tests train on classic LIBSVM datasets such as ``a1a``
(SURVEY.md §4; BASELINE.json: "L2 logistic regression on a1a (LIBSVM)").
This is the host-side text→CSR path; Avro ingest lives in io/avro.py.

NumPy parsing (a file's items converted at once) — the output feeds
:func:`photon_ml_tpu_torch.data.dataset.make_glm_data`, which pads and places
it on the device.
"""

from __future__ import annotations

import re

import numpy as np
import scipy.sparse as sp


def read_libsvm(
    path: str,
    n_features: int | None = None,
    zero_based: bool = False,
    binary_labels_to_01: bool = True,
    add_intercept: bool = False,
    drop_out_of_range: bool = False,
):
    """Read a LIBSVM/SVMlight text file.

    Returns ``(X, y)`` with X a scipy CSR matrix and y float32 labels.
    ``±1`` labels are mapped to ``{0, 1}`` when ``binary_labels_to_01`` (the
    losses' convention).  ``add_intercept`` appends a constant-1 column at
    index ``n_features`` (the reference appends its intercept last as well).
    ``drop_out_of_range`` silently drops features with index >= n_features —
    the scoring/validation convention (features unseen at training time
    contribute nothing), matching the GAME reader's scoring path.
    """
    with open(path) as f:
        text = f.read()
    parsed = _parse_columns(text, zero_based)
    if parsed is None:
        parsed = _parse_items(text, zero_based)
    labels, counts, cols, vals = parsed
    if cols.size and cols.min() < 0:
        raise ValueError(
            f"negative feature index {int(cols[np.argmax(cols < 0)])} — "
            "wrong zero_based setting?"
        )
    if drop_out_of_range and n_features is not None:
        keep = cols < n_features
        counts = np.bincount(np.repeat(np.arange(counts.shape[0]), counts),
                             weights=keep, minlength=counts.shape[0]
                             ).astype(np.int64)
        cols, vals = cols[keep], vals[keep]
    max_col = int(cols.max()) if cols.size else -1
    indptr = np.zeros(counts.shape[0] + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices, values = cols, vals

    n_rows = len(labels)
    d = n_features if n_features is not None else max_col + 1
    if max_col >= d:
        raise ValueError(f"feature index {max_col} >= n_features={d}")
    X = sp.csr_matrix(
        (
            np.asarray(values, np.float32),
            np.asarray(indices, np.int32),
            indptr,
        ),
        shape=(n_rows, d),
    )
    y = np.asarray(labels, np.float32)
    if binary_labels_to_01 and set(np.unique(y)) <= {-1.0, 1.0}:
        y = (y + 1.0) / 2.0
    if add_intercept:
        X = sp.hstack([X, np.ones((n_rows, 1), np.float32)], format="csr")
    return X, y


def write_libsvm(path: str, X, y, zero_based: bool = False) -> None:
    """Inverse of :func:`read_libsvm` (test round-trips, synthetic fixtures)."""
    X = sp.csr_matrix(X)
    offset = 0 if zero_based else 1
    with open(path, "w") as f:
        for i in range(X.shape[0]):
            start, end = X.indptr[i], X.indptr[i + 1]
            feats = " ".join(
                f"{int(c) + offset}:{v:.17g}"
                for c, v in zip(X.indices[start:end], X.data[start:end])
            )
            f.write(f"{y[i]:.17g} {feats}\n".rstrip() + "\n")


def _lines(text: str):
    """The data lines: comments cut, blank lines skipped."""
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            yield line


def _parse_items(text: str, zero_based: bool):
    """(labels, items a row, columns, values), one ``index:value`` item at a
    time (any file :func:`_parse_columns` declines; raises on a malformed
    item)."""
    labels: list[float] = []
    counts: list[int] = []
    indices: list[int] = []
    values: list[float] = []
    offset = 0 if zero_based else 1
    for line in _lines(text):
        parts = line.split()
        labels.append(float(parts[0]))
        for item in parts[1:]:
            idx_s, val_s = item.split(":")
            col = int(idx_s) - offset
            if col < 0:
                raise ValueError(
                    f"negative feature index {col} — wrong zero_based "
                    "setting?"
                )
            indices.append(col)
            values.append(float(val_s))
        counts.append(len(parts) - 1)
    return (np.asarray(labels, np.float64), np.asarray(counts, np.int64),
            np.asarray(indices, np.int64), np.asarray(values, np.float64))


#: a line's items in the plain form ``index:value``: ASCII digits for the
#: index, no colon in the value.
_ITEMS = re.compile(r"\d+:[^\s:]+(?:\s+\d+:[^\s:]+)*", re.ASCII)


def _parse_columns(text: str, zero_based: bool):
    """:func:`_parse_items`'s result with the items of the whole file
    converted at once, or None where a line's items are not all in the
    plain form (the item parser then reads the file and raises what it
    raises)."""
    labels, counts, items = [], [], []
    for line in _lines(text):
        parts = line.split(None, 1)
        rest = parts[1] if len(parts) > 1 else ""
        if rest and not _ITEMS.fullmatch(rest):
            return None
        labels.append(parts[0])
        counts.append(rest.count(":"))
        items.append(rest)
    tokens = " ".join(items).replace(":", " ").split()
    try:
        cols = np.asarray(tokens[0::2], np.int64) - (0 if zero_based else 1)
        vals = np.asarray(tokens[1::2], np.float64)
        y = np.asarray(labels, np.float64)
    except (ValueError, OverflowError):
        return None
    return y, np.asarray(counts, np.int64), cols, vals
