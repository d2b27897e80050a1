"""GAME scoring driver (port of ``photon_ml_tpu/drivers/game_scoring_driver.py``).

The reference's ``GameScoringDriver``: load a saved GameModel, read GAME
Avro data through the SAVED index maps (unseen features drop), score with
``GameTransformer`` (fixed-effect matvec + per-entity random-effect
gathers, summed with offsets, on the host) and write ``ScoringResultAvro``
records to ``scores.avro`` and ``scoring_result.json``.  With
``--evaluator`` the metric is computed too; ``--device-metrics`` computes it
on ``--device`` (CUDA by default), from which only the scalar comes back.
Beside the reference's keys, the result holds ``stage_seconds`` (host
seconds of the model load, the read, the transform and the metric) and
``decoder`` (the GAME decoder that read the file).

``--stream-block-rows`` (bounded-block scoring of files larger than host
memory) raises ``NotImplementedError`` naming ROADMAP.md, PyTorch/CUDA
port, Queue 1 item 5.  Telemetry and the compile cache are left out, as in
the port's GLM driver.

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

from photon_ml_tpu_torch.data.game_reader import read_game_avro
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation.evaluators import get_evaluator
from photon_ml_tpu_torch.game.coordinates import not_ported
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
        help="bounded-block scoring (not ported yet; 0 reads the whole file)",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device for the model and the device metric "
                   "(cuda | cpu)")
    return p


def run(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_arg_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    with PhotonLogger(args.output_dir) as logger:
        return _run_impl(args, logger)


def _run_impl(args, logger) -> dict:
    timer = Timer().start()
    if args.stream_block_rows > 0:
        raise not_ported("--stream-block-rows (streamed scoring)", 5,
                         "out-of-core")
    device = resolve_device(args.device)
    stages, read_stats = {}, {}
    stage = Timer().start()
    model, index_maps = load_game_model(
        os.path.join(args.model_dir, "models"), device=device)
    stages["model load"] = stage.stop()
    transformer = GameTransformer(model, logger=logger)
    stage.start()
    shards, ids, response, weight, offset, uids, _ = read_game_avro(
        args.data, index_maps=index_maps, logger=logger, stats=read_stats)
    stages["read"] = stage.stop()
    stage.start()
    scores = (transformer.transform_with_mean(shards, ids, offset)
              if args.mean else transformer.transform(shards, ids, offset))
    stages["transform"] = stage.stop()
    # Sorted id columns: the canonical map-entry order of the reference's
    # writer.
    avro.write_scoring_container(
        os.path.join(args.output_dir, "scores.avro"), uids,
        np.asarray(scores, np.float32).tolist(),
        np.asarray(response, np.float32).tolist(),
        {k: ids[k] for k in sorted(ids)},
    )
    result = {"n_rows": int(len(scores)), "wall_seconds": timer.stop()}
    if args.evaluator:
        stage.start()
        ev = get_evaluator(args.evaluator)
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
    with open(os.path.join(args.output_dir, "scoring_result.json"), "w") as f:
        json.dump(result, f, indent=2)
    logger.info("scored %d rows in %.2fs", result["n_rows"],
                result["wall_seconds"])
    return result


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
