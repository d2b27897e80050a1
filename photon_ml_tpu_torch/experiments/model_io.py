"""GAME model save and load, and the Avro codec under them (the port's own
probe).

    python -m photon_ml_tpu_torch.experiments.model_io [--entities N]

Builds ``bench_serving``'s synthetic GAME model (a 64-wide fixed effect and
a per-entity effect 8 wide, seed 9) at N entities, saves it with
``save_game_model`` and loads it back with ``load_game_model`` on the CPU,
and times the random-effect file's records through both Avro codecs: the
schema walk (``write_datum`` / ``read_datum``) and the compiled codec the
containers use.  Host work only: no card is needed.  The last line is one
JSON object.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tempfile
import time

from photon_ml_tpu_torch.io import avro
from photon_ml_tpu_torch.io.game_store import (
    RANDOM_EFFECT_MODEL_SCHEMA,
    load_game_model,
    save_game_model,
)
from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload


def _seconds(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--entities", type=int, default=100_000)
    args = p.parse_args(argv)
    bench = SyntheticWorkload(n_entities=args.entities, fixed_dim=64,
                              re_dim=8, seed=9)
    out = {"entities": args.entities}
    with tempfile.TemporaryDirectory() as td:
        d = os.path.join(td, "model")
        out["save_s"] = _seconds(
            lambda: save_game_model(bench.model, bench.index_maps, d))
        out["load_s"] = _seconds(lambda: load_game_model(d, device="cpu"))
        path = next(os.path.join(r, f) for r, _, fs in os.walk(d)
                    for f in fs if f == "coefficients.avro"
                    and "random-effect" in r)
        _, records = avro.read_container(path)
    schema = RANDOM_EFFECT_MODEL_SCHEMA
    walked = io.BytesIO()
    out["encode_walk_s"] = _seconds(
        lambda: [avro.write_datum(walked, schema, r) for r in records])
    parts: list = []
    enc = avro._compile_writer(schema)
    out["encode_compiled_s"] = _seconds(
        lambda: [enc(parts.append, r) for r in records])
    payload = walked.getvalue()
    if b"".join(parts) != payload:
        raise RuntimeError("the compiled writer's bytes differ")

    def walk():
        body = io.BytesIO(payload)
        return [avro.read_datum(body, schema) for _ in records]

    def compiled():
        dec, pos, got = avro._compile_reader(schema), 0, []
        for _ in records:
            rec, pos = dec(payload, pos)
            got.append(rec)
        return got

    out["decode_walk_s"] = _seconds(walk)
    out["decode_compiled_s"] = _seconds(compiled)
    out["records"] = len(records)
    out["payload_bytes"] = len(payload)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
