"""Feature indexing driver (port of
``photon_ml_tpu/drivers/feature_indexing_driver.py``).

The reference's ``FeatureIndexingDriver``: scan GAME Avro data once and
persist per-shard feature-name → column-index maps, so training and scoring
jobs share a stable feature space.  ``--binary`` also writes the
hash-sorted layout of ``data/index_map.py::BinaryIndexMap`` for very wide
spaces.  Host code only: no device is involved.

Usage:
    python -m photon_ml_tpu_torch.drivers.feature_indexing_driver \\
        --data train.avro --output-dir maps [--add-intercept] [--binary]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from photon_ml_tpu_torch.data.game_reader import read_game_avro
from photon_ml_tpu_torch.utils.logging import PhotonLogger


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="feature_indexing_driver",
        description="Build feature index maps from GAME Avro data",
    )
    p.add_argument("--data", required=True, help="GAME Avro file")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--add-intercept", action="store_true")
    p.add_argument("--binary", action="store_true",
                   help="also write the hash-sorted binary layout")
    return p


def run(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_arg_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    with PhotonLogger(args.output_dir) as logger:
        shards, _, response, _, _, _, index_maps = read_game_avro(args.data)
        if args.add_intercept:
            # Shard names are only known after a first read; re-read with
            # an intercept column appended to every shard.
            shards, _, response, _, _, _, index_maps = read_game_avro(
                args.data, add_intercept_shards=tuple(shards))
        sizes = {}
        for shard, imap in index_maps.items():
            target = os.path.join(args.output_dir, shard)
            imap.save(target)
            if args.binary:
                imap.save_binary(target)
            sizes[shard] = len(imap)
            logger.info("shard %s: %d features -> %s", shard, len(imap),
                        target)
        return {"shards": sizes, "n_rows": int(len(response))}


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
