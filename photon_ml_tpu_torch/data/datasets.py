"""Staged named-dataset resolution (port of
``photon_ml_tpu/data/datasets.py``).

The benchmark configurations name public datasets (a1a, MovieLens-20M)
that are not shipped with the repo and are never downloaded here.
:func:`resolve_dataset` finds a staged copy — ``$PHOTON_DATA_DIR/<name>``
first, then ``<repo>/datasets/<name>`` — or returns None, exactly as the
reference does; callers must then skip LOUDLY rather than substitute
synthetic data silently.  :func:`require_dataset` raises instead.
Staging instructions live in ``datasets/README.md``.
"""

from __future__ import annotations

import os
from typing import Optional

_REPO_DATASETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "datasets",
)


def resolve_dataset(name: str) -> Optional[str]:
    """Absolute path of a staged dataset file, or None when not staged."""
    env_dir = os.environ.get("PHOTON_DATA_DIR")
    for root in ([env_dir] if env_dir else []) + [_REPO_DATASETS]:
        path = os.path.join(root, name)
        if os.path.exists(path):
            return path
    return None


def skip_reason(name: str) -> str:
    return (
        f"named dataset {name!r} is not staged (no network egress in this "
        f"environment); stage it under datasets/ or $PHOTON_DATA_DIR — see "
        "datasets/README.md for the exact curl commands"
    )


def require_dataset(name: str) -> str:
    """:func:`resolve_dataset`, raising ``FileNotFoundError`` (with
    :func:`skip_reason`'s text) when the file is not staged; nothing is
    downloaded."""
    path = resolve_dataset(name)
    if path is None:
        raise FileNotFoundError(skip_reason(name))
    return path
