"""GAME scoring driver (port of ``photon_ml_tpu/drivers/game_scoring_driver.py``).

The reference's ``GameScoringDriver``: load a saved GameModel, read GAME
Avro data through the SAVED index maps (unseen features drop), score with
``GameTransformer`` (fixed-effect matvec + per-entity random-effect
gathers, summed with offsets, on the host) and write ``ScoringResultAvro``
records to ``scores.avro`` and ``scoring_result.json``.  With
``--evaluator`` the metric is computed too; ``--device-metrics`` computes it
on ``--device`` (CUDA by default), from which only the scalar comes back.
Beside the reference's keys, the result holds ``stage_seconds`` (host
seconds of the model load, the read, the transform, the streamed write and
the metric), ``decoder`` (the GAME decoder that read the file),
``encoder`` (the scoring writer's: native or Python, the same bytes) and,
when streaming, ``blocks``.

``--stream-block-rows N`` scores files larger than host memory: the data
is decoded, scored and written block by block (``iter_game_avro``, about N
rows a block), every block carrying the model's entity-id columns.  The
score, label and weight columns are kept across blocks only when the
metric is global (AUC); a pointwise metric with ``--device-metrics``
accumulates a (sum, weight) pair a block on the device
(``device_pointwise_partial``).  ``--telemetry on`` (the default) writes
``events.jsonl``, ``trace.json`` and ``metrics.json`` with a ``run`` span
and the ``scored_rows`` and ``run_wall_seconds`` gauges, as the reference
does; the compile cache has no counterpart in the port.

Usage:
    python -m photon_ml_tpu_torch.drivers.game_scoring_driver \\
        --data val.avro --model-dir train_out --output-dir score_out \\
        --evaluator auc --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.data.game_reader import iter_game_avro, read_game_avro
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.drivers.ops_plane import (
    add_telemetry_args,
    driver_telemetry,
)
from photon_ml_tpu_torch.evaluation.evaluators import get_evaluator
from photon_ml_tpu_torch.game.estimator import GameTransformer
from photon_ml_tpu_torch.io import avro
from photon_ml_tpu_torch.io.game_store import load_game_model
from photon_ml_tpu_torch.utils.logging import PhotonLogger
from photon_ml_tpu_torch.utils.timer import Timer


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="game_scoring_driver",
        description="PyTorch/CUDA GAME batch scoring",
    )
    p.add_argument("--data", required=True, help="GAME Avro file to score")
    p.add_argument("--model-dir", required=True,
                   help="the training driver's output directory")
    p.add_argument("--output-dir", required=True)
    p.add_argument(
        "--mean", action="store_true",
        help="emit mean responses (inverse link) instead of raw margins",
    )
    p.add_argument("--evaluator", help="also compute a metric (labels needed)")
    p.add_argument(
        "--device-metrics",
        action="store_true",
        help="compute the metric on --device (only the scalar comes "
        "back); an evaluator with no device version runs on the host",
    )
    p.add_argument(
        "--stream-block-rows",
        type=int,
        default=0,
        help="score in bounded blocks of about this many rows (memory is "
        "one block, plus 12 bytes a row of score/label/weight columns only "
        "when --evaluator needs a global metric); 0 reads the whole file",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device for the model and the device metric "
                   "(cuda | cpu)")
    add_telemetry_args(p, ops_plane=False)
    return p


def run(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_arg_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    with PhotonLogger(args.output_dir) as logger, driver_telemetry(
            args, logger, "game_scoring_driver") as tel:
        return _run_impl(args, logger, tel)


def _score_block(uids, scores, labels, ids):
    """One columnar block for the scoring writer: both paths write through
    it, and the id columns go in sorted order (the canonical map-entry
    order of the reference's writer)."""
    return (uids, np.asarray(scores, np.float32),
            np.asarray(labels, np.float32), {k: ids[k] for k in sorted(ids)})


def _run_impl(args, logger, tel) -> dict:
    timer = Timer().start()
    device = resolve_device(args.device)
    stages, read_stats, write_stats = {}, {}, {}
    stage = Timer().start()
    model, index_maps = load_game_model(
        os.path.join(args.model_dir, "models"), device=device)
    stages["model load"] = stage.stop()
    transformer = GameTransformer(model, logger=logger)
    out_path = os.path.join(args.output_dir, "scores.avro")

    def transform(shards, ids, offset):
        return (transformer.transform_with_mean(shards, ids, offset)
                if args.mean else transformer.transform(shards, ids, offset))

    ev = get_evaluator(args.evaluator) if args.evaluator else None
    partial, extra = None, {}
    if args.stream_block_rows > 0:
        scores, response, weight, partial, n_rows, extra["blocks"] = _stream(
            args, logger, model, index_maps, transform, ev, device,
            out_path, stages, read_stats, write_stats)
    else:
        stage.start()
        shards, ids, response, weight, offset, uids, _ = read_game_avro(
            args.data, index_maps=index_maps, logger=logger,
            stats=read_stats)
        stages["read"] = stage.stop()
        stage.start()
        scores = transform(shards, ids, offset)
        stages["transform"] = stage.stop()
        stage.start()
        avro.write_scoring_blocks(
            out_path, [_score_block(uids, scores, response, ids)],
            stats=write_stats)
        stages["write"] = stage.stop()
        n_rows = len(scores)
    result = {"n_rows": int(n_rows), "wall_seconds": timer.stop(), **extra}
    tel.gauge("scored_rows").set(int(n_rows))
    tel.gauge("run_wall_seconds").set(result["wall_seconds"])
    if ev is not None:
        stage.start()
        if partial is not None:
            from photon_ml_tpu_torch.evaluation.device import (
                finish_pointwise_partial,
            )

            # Streamed + pointwise device metric: the per-block sums hold
            # the whole answer.
            result["metric"] = finish_pointwise_partial(*partial)
        else:
            fn = None
            if args.device_metrics:
                from photon_ml_tpu_torch.evaluation.device import (
                    device_evaluator_fn,
                )

                fn = device_evaluator_fn(ev)
            if fn is not None:
                result["metric"] = float(fn(
                    torch.as_tensor(np.asarray(scores, np.float32),
                                    device=device),
                    torch.as_tensor(response, device=device),
                    torch.as_tensor(weight, device=device),
                ))
            else:
                result["metric"] = ev.evaluate(scores, response, weight)
        result["evaluator"] = type(ev).__name__
        stages["metric"] = stage.stop()
        logger.info("%s = %.6f", type(ev).__name__, result["metric"])
    result["stage_seconds"] = stages
    result["decoder"] = read_stats["decoder"]
    result["encoder"] = write_stats["encoder"]
    with open(os.path.join(args.output_dir, "scoring_result.json"), "w") as f:
        json.dump(result, f, indent=2)
    logger.info("scored %d rows in %.2fs", result["n_rows"],
                result["wall_seconds"])
    return result


def _stream(args, logger, model, index_maps, transform, ev, device,
            out_path, stages, read_stats, write_stats):
    """Decode → score → write a bounded block at a time.  Returns the kept
    (scores, labels, weights) columns (None without a global metric), the
    pointwise partial (num, den, kind) (None unless the metric accumulates
    on the device), the rows scored and the blocks.  ``stages`` gets the
    summed read (decode), transform and write seconds of the blocks."""
    from photon_ml_tpu_torch.evaluation.device import (
        device_pointwise_partial,
        pointwise_kind_for,
    )
    from photon_ml_tpu_torch.game.model import RandomEffectModel

    kind = (pointwise_kind_for(ev)
            if ev is not None and args.device_metrics else None)
    keep_columns = ev is not None and kind is None
    # A block of rows without an entity column must still carry it, or the
    # random-effect scorer would miss it.
    entity_keys = [sub.entity_key for sub in model.models.values()
                   if isinstance(sub, RandomEffectModel)]
    kept = ([], [], [])
    sums = [torch.zeros((), dtype=torch.float64, device=device)
            for _ in range(2)]
    n_rows, n_blocks = [0], [0]
    for k in ("read", "transform", "write"):
        stages[k] = 0.0
    clock = Timer()

    def blocks():
        it = iter_game_avro(args.data, index_maps,
                            block_rows=args.stream_block_rows, logger=logger,
                            id_keys=entity_keys, stats=read_stats)
        while True:
            clock.start()
            blk = next(it, None)
            stages["read"] += clock.stop()
            if blk is None:
                return
            shards, ids, response, weight, offset, uids = blk
            clock.start()
            scores = transform(shards, ids, offset)
            stages["transform"] += clock.stop()
            n_rows[0] += len(scores)
            n_blocks[0] += 1
            if keep_columns:
                kept[0].append(np.asarray(scores, np.float32))
                kept[1].append(response)
                kept[2].append(weight)
            elif kind is not None and len(scores):
                num, den = device_pointwise_partial(
                    torch.as_tensor(np.asarray(scores, np.float32),
                                    device=device),
                    torch.as_tensor(response, device=device),
                    torch.as_tensor(weight, device=device), kind=kind)
                sums[0] += num.to(torch.float64)
                sums[1] += den.to(torch.float64)
            logger.info("scored block of %d rows", len(scores))
            clock.start()
            yield _score_block(uids, scores, response, ids)
            stages["write"] += clock.stop()

    avro.write_scoring_blocks(out_path, blocks(), stats=write_stats)
    columns = ((None, None, None) if not keep_columns else tuple(
        np.concatenate(c) if c else np.zeros(0, np.float32) for c in kept))
    partial = (None if kind is None
               else (float(sums[0]), float(sums[1]), kind))
    return (*columns, partial, n_rows[0], n_blocks[0])


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
