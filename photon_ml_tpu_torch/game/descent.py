"""Block coordinate descent over GAME coordinates (port of
``photon_ml_tpu/game/descent.py``).

Iterate the ordered coordinate list; train each coordinate against the
*residual* scores of all the others (per-row offsets = base offsets + sum
of the other coordinates' scores); refresh that coordinate's scores.
``total`` holds base + Σ coordinate scores, and training coordinate c uses
``total - scores[c]`` as its offsets.

Device scalars in the history (each update's ``score_norm`` and whatever an
``eval_fn`` returns unmaterialized) are read back in ONE batched host copy
a flush: once at the end of the run, or once an iteration when a logger or
checkpointer needs the values then.

Each iteration runs under a ``cd_iteration`` telemetry span with a
``coordinate`` and a ``solver`` span per update, and ends at the
``cd.iteration`` fault site once it is checkpointed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import torch

from photon_ml_tpu_torch import chaos as chaos_mod
from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.coordinates import Coordinate, _state_to_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class _Deferred:
    """Placeholder for a device scalar awaiting the batched flush."""

    index: int
    kind: str  # "f" float, "i" int, "b" bool — per-dtype readback stacks


def _walk_scalars(obj, pred, fn):
    """Map ``fn`` over every leaf matching ``pred`` in nested dicts/lists."""
    if pred(obj):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _walk_scalars(v, pred, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        vals = [_walk_scalars(v, pred, fn) for v in obj]
        return tuple(vals) if isinstance(obj, tuple) else vals
    return obj


def _optimizer_name(coord) -> Optional[str]:
    """Best-effort optimizer label for a coordinate's solver span (the
    config lives at different depths across coordinate flavors)."""
    cfg = getattr(coord, "config", None)
    if cfg is None:
        cfg = getattr(getattr(coord, "problem", None), "config", None)
    opt = getattr(getattr(cfg, "optimizer", None), "optimizer", None)
    return getattr(opt, "value", None)


@dataclasses.dataclass
class CoordinateDescentResult:
    states: dict  # coordinate name -> device state
    scores: dict  # coordinate name -> (N,) device scores
    history: list  # per (iteration, coordinate) log entries


class CoordinateDescent:
    """Reference: ``CoordinateDescent.optimize(coordinates, iterations)``.

    ``pipeline=True`` fires the NEXT coordinate's ``prestage`` hint before
    each update, as the reference's overlap schedule does; the data flow
    is untouched, so results are bitwise those of the serial schedule (a
    resident coordinate's prestage does nothing)."""

    def __init__(
        self, coordinates: Sequence[Coordinate], pipeline: bool = False
    ):
        names = [c.name for c in coordinates]
        assert len(set(names)) == len(names), f"duplicate coordinate names: {names}"
        self.coordinates = list(coordinates)
        self.pipeline = bool(pipeline)

    def _device(self, base_offsets) -> torch.device:
        if isinstance(base_offsets, Tensor):
            return base_offsets.device
        for c in self.coordinates:
            dev = getattr(c, "device", None)
            if dev is not None:
                return dev
        return resolve_device(None)

    def run(
        self,
        base_offsets,
        n_iterations: int = 1,
        eval_fn: Optional[Callable[[int, str, dict, dict], dict]] = None,
        logger=None,
        checkpointer=None,
        initial_states: Optional[dict] = None,
        locked: Sequence[str] = (),
    ) -> CoordinateDescentResult:
        """``eval_fn(iteration, coordinate_name, scores_by_coordinate,
        states_by_coordinate)`` is called after each coordinate update; its
        dict return is recorded in history.

        ``initial_states`` (coordinate name → state) warm-starts from a
        prior model: each coordinate's scores are seeded from its initial
        state.  ``locked`` names coordinates held at their initial state
        (partial retraining): they contribute scores but are never
        retrained.  ``checkpointer`` (an object with ``load()`` and
        ``save(it, total, scores, states, history, locked=...)``) persists
        the loop state after every iteration; when it holds a saved state,
        the run resumes from the last completed iteration."""
        device = self._device(base_offsets)
        base_offsets = torch.as_tensor(base_offsets, dtype=torch.float32,
                                       device=device)
        locked = set(locked)
        names = {c.name for c in self.coordinates}
        if not locked <= names:
            raise ValueError(
                f"locked coordinates {sorted(locked - names)} are not in "
                f"this descent's coordinate list {sorted(names)}"
            )
        if names and locked >= names:
            raise ValueError(
                "every coordinate is locked — nothing to train (a fully "
                "locked run would just re-emit the initial model)"
            )
        scores: dict[str, Tensor] = {
            c.name: torch.zeros_like(base_offsets) for c in self.coordinates
        }
        states: dict[str, object] = {c.name: None for c in self.coordinates}
        total = base_offsets
        history: list[dict] = []
        start_it = 0

        saved = checkpointer.load() if checkpointer is not None else None
        if saved is not None:
            saved_locked = set(saved.get("locked", []))
            if saved_locked != locked:
                raise ValueError(
                    "checkpoint was written with locked coordinates "
                    f"{sorted(saved_locked)} but this run locks "
                    f"{sorted(locked)}; clear the checkpoint or match "
                    "the locked set"
                )
            start_it = saved["iteration"] + 1
            total = _state_to_device(saved["total"], device)
            for coord in self.coordinates:
                scores[coord.name] = _state_to_device(
                    saved["scores"][coord.name], device)
                states[coord.name] = coord.place_state(
                    saved["states"][coord.name], device)
            history = list(saved["history"])
            if logger is not None:
                logger.info(
                    "resuming coordinate descent from iteration %d", start_it
                )
        elif initial_states:
            for coord in self.coordinates:
                st = initial_states.get(coord.name)
                if st is None:
                    continue
                st = coord.place_state(st, device)
                states[coord.name] = st
                s = coord.score(st)
                scores[coord.name] = s
                total = total + s

        pending: list[dict] = []

        def flush():
            """Materialize every deferred device scalar of ``pending`` in
            one host copy per dtype kind (floats stacked in float64, so a
            float64 metric keeps its precision; ints in int64)."""
            if not pending:
                return
            stacks = {"f": [], "i": [], "b": []}

            def grab(a):
                kind = (
                    "f" if a.is_floating_point()
                    else "b" if a.dtype == torch.bool
                    else "i"
                )
                stacks[kind].append(a)
                return _Deferred(len(stacks[kind]) - 1, kind)

            staged = [
                _walk_scalars(
                    entry,
                    lambda o: isinstance(o, Tensor) and o.ndim == 0,
                    grab,
                )
                for entry in pending
            ]
            cast_dtype = {"f": torch.float64, "i": torch.int64,
                          "b": torch.bool}
            vals = {
                k: torch.stack([v.to(device=device, dtype=cast_dtype[k])
                                for v in stack]).cpu().numpy()
                for k, stack in stacks.items() if stack
            }
            cast = {"f": float, "i": int, "b": bool}
            for entry, filled in zip(pending, staged):
                done = _walk_scalars(
                    filled,
                    lambda o: isinstance(o, _Deferred),
                    lambda m: cast[m.kind](vals[m.kind][m.index]),
                )
                entry.clear()
                entry.update(done)
                history.append(entry)
                if logger is not None:
                    logger.info(
                        "CD iter %d coordinate %s: %s", entry["iteration"],
                        entry["coordinate"],
                        {k: v for k, v in entry.items()
                         if k not in ("iteration", "coordinate")},
                    )
            pending.clear()

        for name in locked:
            if states[name] is None:
                raise ValueError(
                    f"locked coordinate {name!r} has no state to hold: "
                    "supply it via initial_states (a prior model) or a "
                    "resumed checkpoint"
                )

        tel = telemetry_mod.current()
        flush_per_iteration = logger is not None or checkpointer is not None
        trainable = [c for c in self.coordinates if c.name not in locked]
        for it in range(start_it, n_iterations):
            it_t0 = time.perf_counter()
            with tel.span("cd_iteration", iteration=it):
                for ci, coord in enumerate(trainable):
                    offsets = total - scores[coord.name]
                    if self.pipeline and ci + 1 < len(trainable):
                        nxt = trainable[ci + 1]
                        nxt.prestage(states[nxt.name])
                    upd_t0 = time.perf_counter()
                    # The coordinate and solver spans cover the HOST wall
                    # of the update (the solver's own host reads included,
                    # not the scoring still queued on the device); the
                    # iteration's achieved wall rides cd_iteration_seconds,
                    # measured across the flush below.
                    with tel.span("coordinate", coordinate=coord.name,
                                  iteration=it):
                        with tel.span("solver", coordinate=coord.name,
                                      optimizer=_optimizer_name(coord)):
                            state = coord.train(
                                offsets, warm_state=states[coord.name])
                        new_score = coord.score(state)
                    states[coord.name] = state
                    total = offsets + new_score
                    scores[coord.name] = new_score

                    entry = {"iteration": it, "coordinate": coord.name}
                    if eval_fn is not None:
                        entry.update(eval_fn(it, coord.name, scores, states))
                    entry["score_norm"] = torch.linalg.vector_norm(new_score)
                    entry["wall_seconds"] = time.perf_counter() - upd_t0
                    pending.append(entry)
                if flush_per_iteration:
                    flush()
                if checkpointer is not None:
                    checkpointer.save(
                        it, total, scores, states, history,
                        locked=sorted(locked),
                    )
                # The CD outer-iteration boundary: iteration ``it`` is
                # complete AND checkpointed; a kill here must resume at
                # it+1 bit-identically.
                chaos_mod.maybe_fail("cd.iteration", iteration=it)
            if flush_per_iteration and tel.enabled:
                # The flush read the iteration's device scalars back, so
                # this wall is achieved wall-clock, not dispatch rate.
                tel.histogram("cd_iteration_seconds").observe(
                    time.perf_counter() - it_t0)
        flush()
        return CoordinateDescentResult(states=states, scores=scores,
                                       history=history)
