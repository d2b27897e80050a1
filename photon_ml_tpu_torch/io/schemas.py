"""Avro schemas for models, scores and feature summaries.

The analogue of the reference's ``photon-avro-schemas`` module:
``BayesianLinearModelAvro`` (coefficient means with optional variances) and
the per-feature summary record.  Field names follow the reference's
conventions (name/term/value triples, ``(INTERCEPT)`` magic name) so models
round-trip between the two packages.  The GAME training-example schema
lives beside its reader (``data/game_reader.py``).
"""

BAYESIAN_LINEAR_MODEL = {
    "type": "record",
    "name": "BayesianLinearModelAvro",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": "string"},
        {"name": "lossFunction", "type": "string"},
        {
            "name": "means",
            "type": {
                "type": "array",
                "items": {
                    "type": "record",
                    "name": "CoefficientAvro",
                    "fields": [
                        {"name": "name", "type": "string"},
                        {"name": "term", "type": "string"},
                        {"name": "value", "type": "double"},
                    ],
                },
            },
        },
        {
            "name": "variances",
            "type": [
                "null",
                {
                    "type": "array",
                    "items": {
                        "type": "record",
                        "name": "CoefficientVarianceAvro",
                        "fields": [
                            {"name": "name", "type": "string"},
                            {"name": "term", "type": "string"},
                            {"name": "value", "type": "double"},
                        ],
                    },
                },
            ],
        },
    ],
}

SCORING_RESULT = {
    "type": "record",
    "name": "ScoringResultAvro",
    "fields": [
        {"name": "uid", "type": ["null", "string"]},
        {"name": "predictionScore", "type": "double"},
        {"name": "label", "type": ["null", "double"]},
        {"name": "ids", "type": {"type": "map", "values": "string"}},
    ],
}

FEATURE_SUMMARY = {
    "type": "record",
    "name": "FeatureSummaryAvro",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "mean", "type": "double"},
        {"name": "variance", "type": "double"},
        {"name": "min", "type": "double"},
        {"name": "max", "type": "double"},
        {"name": "nonzeroCount", "type": "long"},
        {"name": "totalWeight", "type": "double"},
    ],
}
