"""Length-prefixed request/response framing for serving worker IPC (port of
``photon_ml_tpu/serving/protocol.py``).

One frame = a 4-byte big-endian payload length + a 1-byte payload kind
+ the payload body.  Both ends of the parent↔worker socketpair speak
it (serving/procpool.py routes, serving/worker.py serves).  Sends are
serialized under a lock — the parent's request threads and the
swapper, and the worker's dispatch callbacks and heartbeat thread, all
write the same socket — so frames never interleave.  Each side has
exactly one reader thread, so receives need no lock.

The hot path rides the binary wire codec (serving/wire.py) instead of
pickle: a ``{"kind": "score", ...}`` submission encodes as a score IPC
frame and a successful ``{"kind": "result", ...}`` as a result IPC
frame — no pickling a Row per request, no unpickling a dict per
result.  Everything else (stats, swaps, quota leases, heartbeats,
error results) stays pickled; the payload kind byte tells the receiver
which decoder to run, so the two coexist on one stream and any message
the codec cannot express falls back to pickle transparently.

``recv`` returns ``None`` on a clean EOF (peer closed or died); a
partial frame at EOF raises :class:`ProtocolError` — the caller treats
both as "worker gone" and fails in-flight work with a transient error
the supervisor resubmits.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Any, Optional

from photon_ml_tpu_torch.serving import wire as wire_mod

__all__ = ["FrameConn", "ProtocolError", "MAX_FRAME_BYTES"]

_HEADER = struct.Struct(">I")

#: sanity ceiling, not a tuning knob — a scoring row or a manifest is
#: kilobytes; a length beyond this means a corrupt or desynced stream.
MAX_FRAME_BYTES = 256 << 20

#: payload kind byte: what follows the length header.
_PAYLOAD_PICKLE = 0
_PAYLOAD_SCORE = 1
_PAYLOAD_RESULT = 2

#: a success value with exactly these keys is wire-expressible; stats
#: dicts and quota acks keep their pickle shape.
_RESULT_KEYS = frozenset(("score", "mean", "latency_ms"))


class ProtocolError(RuntimeError):
    """The byte stream desynced (oversized length or truncated frame)."""


def _encode_payload(message: Any) -> bytes:
    """Binary-encode hot-path messages; pickle the rest.  Any encode
    failure (a row the codec can't express, a foreign dict shape)
    falls back to pickle — correctness never depends on the fast
    path."""
    if isinstance(message, dict):
        kind = message.get("kind")
        try:
            if (
                kind == "score"
                and isinstance(message.get("id"), int)
                # The stage-annotation opt-in flag has no wire column;
                # it rides the pickle fallback (it is off the hot path
                # by definition).
                and not message.get("stages")
            ):
                return bytes([_PAYLOAD_SCORE]) + wire_mod.encode_score_ipc(
                    message["id"],
                    message["row"],
                    tenant=message.get("tenant"),
                    timeout_ms=message.get("timeout_ms"),
                    bypass=bool(message.get("bypass")),
                    trace=message.get("trace"),
                )
            if (
                kind == "result"
                and message.get("ok") is True
                and isinstance(message.get("id"), int)
                and isinstance(message.get("value"), dict)
                and set(message["value"]) == _RESULT_KEYS
            ):
                return bytes([_PAYLOAD_RESULT]) + wire_mod.encode_result_ipc(
                    message["id"], message["value"],
                    trace=message.get("trace"),
                )
        except Exception:  # noqa: BLE001 — fall back to pickle
            pass
    return bytes([_PAYLOAD_PICKLE]) + pickle.dumps(
        message, protocol=pickle.HIGHEST_PROTOCOL
    )


def _decode_payload(payload: bytes) -> Any:
    if not payload:
        raise ProtocolError("empty frame payload")
    tag, body = payload[0], memoryview(payload)[1:]
    if tag == _PAYLOAD_PICKLE:
        return pickle.loads(body)
    try:
        if tag == _PAYLOAD_SCORE:
            return wire_mod.decode_score_ipc(body)
        if tag == _PAYLOAD_RESULT:
            return wire_mod.decode_result_ipc(body)
    except wire_mod.WireFormatError as exc:
        raise ProtocolError(f"corrupt wire payload: {exc}") from exc
    raise ProtocolError(f"unknown payload kind byte {tag}")


class FrameConn:
    """One framed, pickling connection over a connected socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._closed = False

    def fileno(self) -> int:
        return self._sock.fileno()

    def send(self, message: Any) -> None:
        payload = _encode_payload(message)
        if len(payload) > MAX_FRAME_BYTES:
            raise ProtocolError(
                f"refusing to send a {len(payload)}-byte frame "
                f"(cap {MAX_FRAME_BYTES})"
            )
        frame = _HEADER.pack(len(payload)) + payload
        with self._send_lock:
            self._sock.sendall(frame)

    def _recv_exact(self, n: int) -> Optional[bytes]:
        chunks = []
        remaining = n
        while remaining:
            chunk = self._sock.recv(min(remaining, 1 << 20))
            if not chunk:
                if not chunks:
                    return None  # clean EOF between frames
                raise ProtocolError(
                    f"truncated frame: EOF with {remaining} of {n} "
                    "bytes unread"
                )
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    def recv(self) -> Optional[Any]:
        """Next message, or ``None`` on clean EOF."""
        header = self._recv_exact(_HEADER.size)
        if header is None:
            return None
        (length,) = _HEADER.unpack(header)
        if length > MAX_FRAME_BYTES:
            raise ProtocolError(
                f"frame length {length} exceeds cap {MAX_FRAME_BYTES}; "
                "stream is desynced"
            )
        payload = self._recv_exact(length)
        if payload is None:
            raise ProtocolError("truncated frame: EOF before payload")
        return _decode_payload(payload)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
