"""The port's vectorised host paths against the record-at-a-time forms they
replace, on the CPU: the composite-key stable sort of the kernel layouts,
the random-effect model file's flat encoder, checksum and reader, and the
LIBSVM reader's whole-file conversion.  Outputs are held EXACTLY: the same
permutations, the same bytes, the same arrays, the same errors."""

import json

import numpy as np
import pytest

from photon_ml_tpu.data import libsvm as ref_libsvm
from photon_ml_tpu.io import game_store as ref_store
from photon_ml_tpu_torch.data import libsvm
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.game.model import GameModel, RandomEffectModel
from photon_ml_tpu_torch.io import avro, game_store
from photon_ml_tpu_torch.ops.sparse import stable_argsort


# -- the composite-key stable sort ----------------------------------------


@pytest.mark.parametrize("n,bound", [
    (0, 4), (1, 4), (1000, 3), (50_000, 8192), (20_000, 1 << 40),
    (10_000, 1 << 62),  # past int64 with the positions: numpy's own sort
])
def test_stable_argsort_is_numpys_stable_argsort(n, bound):
    keys = np.random.default_rng(n).integers(0, bound, size=n)
    np.testing.assert_array_equal(stable_argsort(keys, bound),
                                  np.argsort(keys, kind="stable"))


# -- the random-effect model file -----------------------------------------


def _effect(n_entities, dim, seed, variances, empty):
    rng = np.random.default_rng(seed)
    imap = IndexMap.build([f"f{j}\x01t{j % 3}" if j % 2 else f"g{j}"
                           for j in range(dim)])
    coefs = {}
    for e in range(n_entities):
        k = 0 if e in empty else int(rng.integers(1, dim + 1))
        cols = np.sort(rng.choice(dim, size=k, replace=False)).astype(
            np.int32)
        coefs[f"user-{e}" if e % 5 else e] = (
            cols, rng.normal(size=k).astype(np.float32))
    var = None
    if variances:
        var = {k: np.abs(v) + 0.5 for i, (k, (_, v)) in
               enumerate(coefs.items()) if i % 3 == 0}
    sub = RandomEffectModel(coefficients=coefs, feature_shard="s",
                            entity_key="userId", task="logistic",
                            n_features=dim, variances=var)
    return GameModel(models={"per_user": sub}, task="logistic"), {"s": imap}


def _records(sub, imap):
    """The records one entity at a time, as the reference builds them."""
    out = []
    for entity, (cols, vals) in sub.coefficients.items():
        var = (sub.variances.get(entity) if sub.variances is not None
               else None)
        coefs = []
        for j, (c, v) in enumerate(zip(cols, vals)):
            name, _, term = imap.index_to_name(int(c)).partition("\x01")
            coefs.append({"name": name, "term": term, "value": float(v),
                          "variance": None if var is None
                          else float(var[j])})
        out.append({"entityId": str(entity), "coefficients": coefs})
    return out


EFFECTS = {
    "plain": dict(n_entities=9000, dim=12, seed=0, variances=False,
                  empty=()),
    "variances": dict(n_entities=5000, dim=7, seed=1, variances=True,
                      empty=(3,)),
    "empty_entities": dict(n_entities=300, dim=40, seed=2, variances=True,
                           empty=(0, 1, 299)),
}


@pytest.mark.parametrize("case", sorted(EFFECTS))
def test_saved_effect_is_the_record_encoding(tmp_path, case):
    model, imaps = _effect(**EFFECTS[case])
    game_store.save_game_model(model, imaps, str(tmp_path / "m"))
    sub = model.models["per_user"]
    records = _records(sub, imaps["s"])
    expect = tmp_path / "expect.avro"
    avro.write_container(str(expect), game_store.RANDOM_EFFECT_MODEL_SCHEMA,
                         records)
    got = tmp_path / "m" / "random-effect" / "per_user" / "coefficients.avro"
    assert got.read_bytes() == expect.read_bytes()
    fp = json.loads((tmp_path / "m" / "metadata.json").read_text())[
        "fingerprints"]["per_user"]
    assert fp["coefficient_checksum"] == \
        ref_store.random_effect_checksum(records)
    assert fp["n_entities"] == len(records)


def _tables_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        for x, y in zip(a[k] if isinstance(a[k], tuple) else (a[k],),
                        b[k] if isinstance(b[k], tuple) else (b[k],)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _irregular_records(records):
    """Records the saver never writes but a file may hold: columns out of
    order, a variance on one coefficient, a feature the index map lacks,
    a repeated entity and a non-ASCII id."""
    records = [dict(r, coefficients=list(r["coefficients"]))
               for r in records]
    records[0]["coefficients"].reverse()
    records[2]["coefficients"][0] = dict(records[2]["coefficients"][0],
                                         variance=0.25)
    records[3]["coefficients"].append(
        {"name": "unknown", "term": "x", "value": 1.5, "variance": 2.0})
    records.append({"entityId": records[4]["entityId"], "coefficients": [
        dict(c, variance=1.0) for c in records[4]["coefficients"]]})
    records.append({"entityId": "üser", "coefficients":
                    records[5]["coefficients"]})
    return records


@pytest.mark.parametrize("case", sorted(EFFECTS) + ["irregular"])
def test_effect_reader_is_the_record_reader(tmp_path, case):
    model, imaps = _effect(**EFFECTS.get(case, EFFECTS["variances"]))
    records = _records(model.models["per_user"], imaps["s"])
    if case == "irregular":
        records = _irregular_records(records)
    path = str(tmp_path / "e.avro")
    avro.write_container(path, game_store.RANDOM_EFFECT_MODEL_SCHEMA,
                         records, records_per_block=1000)
    flat = game_store._read_effect(path)
    assert flat is not None
    assert flat.checksum() == ref_store.random_effect_checksum(records)
    fast = game_store._effect_tables(flat, imaps["s"])
    slow = game_store._tables_from_records(avro.read_container(path)[1],
                                           imaps["s"])
    _tables_equal(fast[0], slow[0])
    _tables_equal(fast[1], slow[1])


def test_effect_reader_declines_another_schema(tmp_path):
    schema = json.loads(json.dumps(game_store.RANDOM_EFFECT_MODEL_SCHEMA))
    item = schema["fields"][1]["type"]["items"]
    item["fields"] = item["fields"][:3]  # no variance field
    path = str(tmp_path / "old.avro")
    avro.write_container(path, schema, [{"entityId": "a", "coefficients": [
        {"name": "g0", "term": "", "value": 1.0}]}])
    assert game_store._read_effect(path) is None


def test_saved_model_loads_in_both_packages(tmp_path):
    model, imaps = _effect(**EFFECTS["variances"])
    game_store.save_game_model(model, imaps, str(tmp_path / "m"))
    ours, _ = game_store.load_game_model(str(tmp_path / "m"), device="cpu")
    ref, _ = ref_store.load_game_model(str(tmp_path / "m"))
    a, b = ours.models["per_user"], ref.models["per_user"]
    assert list(a.coefficients) == list(b.coefficients)
    for k in a.coefficients:
        for x, y in zip(a.coefficients[k], b.coefficients[k]):
            np.testing.assert_array_equal(x, np.asarray(y))
    assert list(a.variances) == list(b.variances)


def test_tampered_effect_fails_its_checksum(tmp_path):
    model, imaps = _effect(**EFFECTS["plain"])
    game_store.save_game_model(model, imaps, str(tmp_path / "m"))
    meta = tmp_path / "m" / "metadata.json"
    manifest = json.loads(meta.read_text())
    manifest["fingerprints"]["per_user"]["coefficient_checksum"] = "0" * 64
    meta.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="checksum mismatch"):
        game_store.load_game_model(str(tmp_path / "m"), device="cpu")


@pytest.mark.parametrize("bad", ["nan_value", "inf_variance"])
def test_non_finite_effect_is_refused(tmp_path, bad):
    model, imaps = _effect(**EFFECTS["variances"])
    sub = model.models["per_user"]
    key = list(sub.coefficients)[6]
    if bad == "nan_value":
        cols, vals = sub.coefficients[key]
        sub.coefficients[key] = (cols, np.full_like(vals, np.nan))
    else:
        key = list(sub.variances)[2]
        sub.variances[key] = np.full_like(sub.variances[key], np.inf)
    with pytest.raises(ValueError, match=f"entity {key!r} carries "
                       "non-finite"):
        game_store.save_game_model(model, imaps, str(tmp_path / "m"))


# -- the LIBSVM reader ----------------------------------------------------


TEXTS = {
    "plain": "1 1:0.5 3:2\n-1 2:1e-3\n\n# a comment\n+1 4:1 # tail\n-1\n",
    "tabs": "1\t1:0.5\t3:2\n-1  2:1e-3 \n",
    "zero_based": "0 0:1 2:3\n1 1:2.5\n",
    "long_values": "1 1:0.10000000000000000555 2:-1.7976931348623157e308\n",
    "out_of_range": "1 9:1 2:2\n0 12:3\n",
    "two_colons": "1 1:2:3 5\n",
    "bad_value": "1 1:abc\n",
    "signed_index": "1 +3:1\n",
    "negative_index": "1 0:1 2:3\n",
}


def _read(mod, path, **kw):
    try:
        X, y = mod.read_libsvm(path, **kw)
    except Exception as e:  # the same error, or the same arrays
        return type(e).__name__, str(e)
    return (X.shape, X.indptr.tolist(), X.indices.tolist(), X.data.tolist(),
            y.tolist(), str(X.data.dtype), str(X.indices.dtype))


@pytest.mark.parametrize("kw", [
    {}, {"zero_based": True}, {"n_features": 5, "drop_out_of_range": True},
    {"n_features": 20, "add_intercept": True}, {"n_features": 3},
], ids=["default", "zero_based", "drop", "intercept", "narrow"])
@pytest.mark.parametrize("case", sorted(TEXTS))
def test_libsvm_reader_is_the_references(tmp_path, case, kw):
    path = str(tmp_path / "d.libsvm")
    with open(path, "w") as f:
        f.write(TEXTS[case])
    assert repr(_read(libsvm, path, **kw)) == repr(_read(ref_libsvm, path,
                                                         **kw))


def test_libsvm_whole_file_conversion_is_the_item_parser(tmp_path):
    rng = np.random.default_rng(4)
    lines = []
    for i in range(2000):
        cols = np.sort(rng.choice(300, size=int(rng.integers(0, 9)),
                                  replace=False)) + 1
        lines.append(("+1" if i % 2 else "-1") + "".join(
            f" {c}:{rng.normal():.17g}" for c in cols))
    text = "\n".join(lines) + "\n"
    fast = libsvm._parse_columns(text, False)
    slow = libsvm._parse_items(text, False)
    assert fast is not None
    for a, b in zip(fast, slow):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
