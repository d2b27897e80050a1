"""Native (C++) host ingest and scoring output, loaded via ctypes (port of
``photon_ml_tpu/native/__init__.py``'s game decoder and score encoder).

``game_decoder.cpp`` and ``score_encoder.cpp`` (the port's own copies of
the reference's sources) build lazily with the system ``g++`` the first
time each is needed, into ``photon_ml_tpu_torch/_build/`` (git-ignored),
keyed by a hash of the source; a build never lands next to either
package's sources.  :func:`load_game_decoder` and
:func:`load_score_encoder` return None when no compiler is available or
the build fails, and ``data/game_reader.py`` then decodes, and
``io/avro.py::write_scoring_blocks`` encodes, in Python (the same bytes).
Set ``PHOTON_NO_NATIVE=1`` to force the Python paths (the parity tests
do).

This is host code: the decoder fills numpy columns and the encoder reads
them, nothing touches a device.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "game_decoder.cpp"
_ENC_SRC = _DIR / "score_encoder.cpp"
BUILD_DIR = _DIR.parent / "_build"
_LOCK = threading.Lock()
_CACHE: dict = {}

logger = logging.getLogger(__name__)


def _compile_cached(src: Path, prefix: str, what: str) -> Optional[Path]:
    """Lazy shared-library build: a hash-tagged ``.so`` in ``BUILD_DIR``,
    installed atomically (concurrent builds race safely); None and a
    warning on any failure (missing source or toolchain, compile error)."""
    try:
        tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    except OSError as e:
        logger.warning("native %s source unreadable (%s)", what, e)
        return None
    so_path = BUILD_DIR / f"{prefix}_{tag}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{so_path.name}.build.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp),
           str(src)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning(
            "native %s build failed (%s): %s — using the Python path",
            what, e, detail.decode(errors="replace")[:500],
        )
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so_path)
    return so_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_void = ctypes.c_void_p
    c_i64 = ctypes.c_int64
    c_char_p = ctypes.c_char_p
    p_i64 = ctypes.POINTER(c_i64)
    p_f64 = ctypes.POINTER(ctypes.c_double)
    sig = {
        "gd_new": ([ctypes.c_int], c_void),
        "gd_free": ([c_void], None),
        "gd_preload_shard": (
            [c_void, c_char_p, ctypes.POINTER(c_char_p), c_i64], None),
        "gd_decode_block": ([c_void, c_char_p, c_i64, c_i64], c_i64),
        "gd_error": ([c_void], c_char_p),
        "gd_n_rows": ([c_void], c_i64),
        "gd_copy_row_data": ([c_void, p_f64, p_f64, p_f64], None),
        "gd_uid_blob_len": ([c_void], c_i64),
        "gd_copy_uids": ([c_void, c_char_p, p_i64, p_i64], None),
        "gd_n_id_cols": ([c_void], c_i64),
        "gd_id_col_name": ([c_void, c_i64], c_char_p),
        "gd_id_col_blob_len": ([c_void, c_i64], c_i64),
        "gd_copy_id_col": ([c_void, c_i64, c_char_p, p_i64, p_i64], None),
        "gd_n_shards": ([c_void], c_i64),
        "gd_shard_name": ([c_void, c_i64], c_char_p),
        "gd_shard_nnz": ([c_void, c_i64], c_i64),
        "gd_shard_dropped": ([c_void, c_i64], c_i64),
        "gd_shard_unknown": ([c_void, c_i64], c_i64),
        "gd_shard_seen": ([c_void, c_i64], c_i64),
        "gd_copy_shard_coo": (
            [c_void, c_i64, p_i64, p_i64, ctypes.POINTER(ctypes.c_float)],
            None),
        "gd_shard_nkeys": ([c_void, c_i64], c_i64),
        "gd_shard_keys_blob_len": ([c_void, c_i64], c_i64),
        "gd_copy_shard_keys": ([c_void, c_i64, c_char_p, p_i64], None),
    }
    for name, (argtypes, restype) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load_game_decoder() -> Optional[ctypes.CDLL]:
    """The bound decoder library, building it if needed; None on failure or
    when ``PHOTON_NO_NATIVE=1``."""
    if os.environ.get("PHOTON_NO_NATIVE") == "1":
        return None
    with _LOCK:
        if "lib" in _CACHE:
            return _CACHE["lib"]
        so_path = _compile_cached(_SRC, "_game_decoder", "game decoder")
        lib = None
        if so_path is not None:
            try:
                lib = _bind(ctypes.CDLL(str(so_path)))
            except OSError as e:
                logger.warning("native game decoder load failed: %s", e)
        _CACHE["lib"] = lib
        return lib


def _bind_encoder(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    p_i64 = ctypes.POINTER(i64)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_f64 = ctypes.POINTER(ctypes.c_double)
    lib.se_encode.argtypes = [
        i64,
        ctypes.c_char_p, p_i64, p_u8,
        p_f64,
        p_f64, p_u8,
        i64,
        ctypes.c_char_p, p_i64, p_u8,
        ctypes.c_char_p, p_i64,
        ctypes.c_char_p, i64,
    ]
    lib.se_encode.restype = i64
    return lib


def load_score_encoder() -> Optional[ctypes.CDLL]:
    """The bound scoring-result encoder library, building it if needed;
    None on failure or when ``PHOTON_NO_NATIVE=1`` (the Python path writes
    the same bytes)."""
    if os.environ.get("PHOTON_NO_NATIVE") == "1":
        return None
    with _LOCK:
        if "encoder" in _CACHE:
            return _CACHE["encoder"]
        so_path = _compile_cached(_ENC_SRC, "_score_encoder", "score encoder")
        lib = None
        if so_path is not None:
            try:
                lib = _bind_encoder(ctypes.CDLL(str(so_path)))
            except OSError as e:
                logger.warning("native score encoder load failed: %s", e)
        _CACHE["encoder"] = lib
        return lib
