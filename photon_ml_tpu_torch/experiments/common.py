"""What the experiment scripts share: the chained-pass loop and its CUDA
graph, and timing that names its clock."""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.utils.timer import median_ms

#: chained passes per timed chain, as in the reference scripts (R = 10).
REPS = 10
#: timed calls per measurement: device time on the card, a few host-clock
#: calls on the CPU (where the plain versions are slow and the number is
#: not a device metric).
N_TIMED = {"cuda": 50, "cpu": 3}


def run_chain(step, w, reps: int):
    """``reps`` passes of ``w ← step(w)``, eagerly (one launch each)."""
    for _ in range(reps):
        w = step(w)
    return w


class ChainGraph:
    """``reps`` chained passes ``w ← step(w)`` captured once in a CUDA
    graph, the counterpart of the reference's one jitted ``fori_loop``.

    Each :meth:`replay` runs all ``reps`` passes with one host call, so the
    gap between its time and the eager loop's is the host's launch cost.
    A kernel wrapper counts its launches at capture (``reps``), not at
    replay; :attr:`replays` counts replays, so the graph has launched the
    kernel ``reps × replays`` times."""

    def __init__(self, step, w: torch.Tensor, reps: int = REPS):
        if w.device.type != "cuda":
            raise ValueError(f"ChainGraph: CUDA graphs need a CUDA tensor, "
                             f"got one on {w.device}")
        self.reps = reps
        self.replays = 0
        self._w_in = w.clone()
        # One pass outside the capture loads the kernel library and sets its
        # launch attributes, which a capture must not do.
        side = torch.cuda.Stream(w.device)
        side.wait_stream(torch.cuda.current_stream(w.device))
        with torch.cuda.stream(side):
            step(self._w_in)
        torch.cuda.current_stream(w.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._w_out = run_chain(step, self._w_in, reps)

    def replay(self) -> torch.Tensor:
        """Run the captured passes on the current input; the returned tensor
        is the graph's own output buffer (overwritten by the next replay)."""
        self.graph.replay()
        self.replays += 1
        return self._w_out

    def __call__(self, w: torch.Tensor) -> torch.Tensor:
        self._w_in.copy_(w)
        return self.replay().clone()


def chain(step, w, reps: int = REPS, graph: bool = True):
    """``reps`` passes of ``w ← step(w)``: as one CUDA-graph replay when
    ``graph`` and ``w`` is on the card, else eagerly."""
    if graph and w.device.type == "cuda":
        return ChainGraph(step, w, reps)(w)
    return run_chain(step, w, reps)


def timed_ms(fn, device: torch.device) -> tuple[float, str]:
    """The median time of one call of ``fn`` and the clock it was read
    from: CUDA events on the card, the host clock on the CPU."""
    ms = median_ms(fn, device, N_TIMED[device.type])
    return ms, ("device" if device.type == "cuda" else "host clock, cpu")


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} (cuda)"
    return "cpu (plain PyTorch versions)"


def game_multi_re_draw(entities: int = 100_000):
    """``bench.py``'s ``bench_game_multi_re`` draw (seed 3; 646,253 rows
    at the default ``entities``): a 512-wide fixed effect with 8 normal
    values a row, per-user (zipf 1.8 rows a user, capped at 128), per-item
    (a zipf 1.5 pool of entities / 5 items, capped at 512 rows an item)
    and per-context (200 contexts, active cap 256: passive rows) random
    effects, each 8 wide and dense; coin-flip labels.  Returns
    (n, Xg, y, [(name, keys, Xe, cap)])."""
    import numpy as np
    import scipy.sparse as sp

    row_cap, fixed_features, fixed_nnz, re_dim = 128, 512, 8, 8
    rng = np.random.default_rng(3)
    sizes = np.minimum(rng.zipf(1.8, entities), row_cap)
    n = int(sizes.sum())
    users = np.repeat(
        np.array([f"u{i}" for i in range(entities)], dtype=object),
        sizes)[rng.permutation(n)]
    n_items = max(2, entities // 5)
    item_sizes = np.minimum(rng.zipf(1.5, n_items), 4 * row_cap)
    item_pool = np.repeat(
        np.array([f"i{i}" for i in range(n_items)], dtype=object),
        item_sizes)
    items = item_pool[rng.integers(0, len(item_pool), size=n)]
    ctx = np.array([f"c{rng.integers(200)}" for _ in range(n)],
                   dtype=object)
    nnzf = n * fixed_nnz
    Xg = sp.csr_matrix(
        (rng.normal(size=nnzf).astype(np.float32),
         (np.repeat(np.arange(n, dtype=np.int64), fixed_nnz),
          rng.integers(0, fixed_features, size=nnzf))),
        shape=(n, fixed_features))
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    effects = []
    for name, keys, cap in (("per_user", users, None),
                            ("per_item", items, None),
                            ("per_context", ctx, 256)):
        Xe = sp.csr_matrix(rng.normal(size=(n, re_dim)).astype(np.float32))
        effects.append((name, keys, Xe, cap))
    return n, Xg, y, effects
