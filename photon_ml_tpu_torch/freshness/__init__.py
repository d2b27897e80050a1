"""Continuous train→serve loop: delta publishing, online refinement,
freshness SLOs (port of
``photon_ml_tpu/freshness``).

The train→serve handoff used to be a full model directory plus a full
fingerprint-verified reload — a model is only as fresh as the slowest
end-to-end retrain+swap.  This package closes the loop (docs/freshness.md):

- :mod:`photon_ml_tpu_torch.freshness.delta` — diff two models into a compact,
  self-digested artifact holding only the changed entities, and apply it
  back with bitwise parity against a full reload.
- :mod:`photon_ml_tpu_torch.freshness.publisher` — crash-safe publication:
  append-only journal (``tuning/state.py`` style) around an
  atomic-rename artifact write, so a crash mid-publish resumes exactly;
  bounded retention (keep-last-K pruning + journal compaction) gated on
  the per-subscriber ack sidecar, so a root never outgrows its disk and
  never drops a delta a registered subscriber still needs.
- :mod:`photon_ml_tpu_torch.freshness.applier` — subscribe side: watch a
  publication root and hot-apply new deltas into a live service.
- :mod:`photon_ml_tpu_torch.freshness.online` — seeded per-entity SGD/AdaGrad
  refinement consuming labeled events between full CD sweeps,
  warm-started from the serving model, publishing through the same
  delta path.

Freshness is measured, not assumed: every publication carries the wall
epoch of its newest event, and the apply side records
``freshness_event_to_servable_seconds`` the moment the delta is live.
"""

from photon_ml_tpu_torch.freshness.delta import (  # noqa: F401
    DeltaBaseMismatchError,
    DeltaError,
    DeltaFormatError,
    ModelDelta,
    apply_delta,
    diff_game_models,
    diff_model_dirs,
    model_table_checksums,
    read_delta,
    write_delta,
)
from photon_ml_tpu_torch.freshness.publisher import (  # noqa: F401
    DeltaPublisher,
    Publication,
    read_acks,
    read_publications,
    write_ack,
)
from photon_ml_tpu_torch.freshness.applier import DeltaApplier  # noqa: F401
from photon_ml_tpu_torch.freshness.online import (  # noqa: F401
    LabeledEvent,
    OnlineRefiner,
    RefinerConfig,
)
