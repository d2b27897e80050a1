"""Multi-process runtime glue (port of ``photon_ml_tpu/parallel/multihost.py``).

The reference brings up JAX's distributed runtime so that the devices of
every host join one mesh.  The port brings up a ``torch.distributed``
process group, one rank per card (NCCL on the card, gloo on the CPU), from
the same arguments or environment variables:

1. :func:`initialize` — ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
   ``PROCESS_ID`` (or their ``JAX_``-prefixed forms), with the launcher's
   own ``env://`` variables (``torchrun``'s ``MASTER_ADDR``, ``RANK``,
   ``WORLD_SIZE``) as the opt-in fallback under ``PHOTON_MULTIHOST=1``;
2. :func:`global_data_mesh` — the process group as a
   :class:`~photon_ml_tpu_torch.parallel.distributed.DataGroup`;
3. :func:`host_local_rows` — this rank's contiguous block of a global row
   space, the block ``shard_glm_data`` gives the rank.

A single process degenerates cleanly: ``initialize`` is a no-op returning
False, ``host_local_rows`` returns the full range.  The reference's
``assemble_global`` has no counterpart: no rank ever holds a global tensor,
each holds its own block.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence, Tuple

import torch

from photon_ml_tpu_torch.parallel.distributed import DataGroup

_ENV_COORD = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")


def _env_first(names: Sequence[str]) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The process group's size; 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if is_initialized() else 1


def _backend(device) -> str:
    from photon_ml_tpu_torch.device import resolve_device

    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def _init_method(address: str) -> str:
    """``host:port`` → ``tcp://host:port``; a URL (``file://...``,
    ``tcp://...``, ``env://``) is used as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Bring up the process group; returns True if it has more than one
    rank.

    Arguments fall back to environment variables
    (``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``, or their
    ``JAX_``-prefixed forms); with ``PHOTON_MULTIHOST=1`` and no explicit
    config, the launcher's ``env://`` variables are read.  Without any of
    those this is a no-op returning False — safe to call unconditionally at
    driver start.  An already initialised group is kept.  The backend is
    NCCL when ``device`` resolves to CUDA, else gloo; under NCCL each rank
    takes the card ``LOCAL_RANK`` names (0 when unset)."""
    if is_initialized():
        return world_size() > 1
    from_args = any(
        v is not None for v in (coordinator_address, num_processes, process_id)
    )
    coordinator_address = coordinator_address or _env_first(_ENV_COORD)
    # The JAX_-prefixed variables are deliberate multi-process config and
    # always count (a partial set fails loudly below).  The UNPREFIXED
    # NUM_PROCESSES / PROCESS_ID are common in unrelated tooling, so they
    # count only once a coordinator address or an argument shows intent.
    intent = coordinator_address is not None or from_args
    env_nproc = os.environ.get("JAX_NUM_PROCESSES") or (
        os.environ.get("NUM_PROCESSES") if intent else None
    )
    env_pid = os.environ.get("JAX_PROCESS_ID") or (
        os.environ.get("PROCESS_ID") if intent else None
    )
    num_processes = (
        num_processes if num_processes is not None
        else (int(env_nproc) if env_nproc else None)
    )
    process_id = (
        process_id if process_id is not None
        else (int(env_pid) if env_pid else None)
    )
    explicit = (coordinator_address, num_processes, process_id)
    if all(v is None for v in explicit):
        # No explicit config: the launcher's variables only on explicit
        # opt-in — a half-configured env:// rendezvous blocks waiting for
        # peers, which must never happen to a single-process driver run.
        if os.environ.get("PHOTON_MULTIHOST") != "1":
            return False
        return _init("env://", None, None, device)
    if any(v is None for v in explicit):
        # A partial config is a deployment bug (a scheduler template lost
        # a variable): fail loudly rather than hang or run single-process.
        raise ValueError(
            "multi-process initialization needs ALL of coordinator_address, "
            "num_processes, process_id (or none of them); got "
            f"coordinator_address={coordinator_address!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r}"
        )
    return _init(_init_method(coordinator_address), num_processes,
                 process_id, device)


def _init(init_method: str, size, rank, device) -> bool:
    import torch.distributed as dist

    backend = _backend(device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    kwargs = {} if size is None else {"world_size": size, "rank": rank}
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    return dist.get_world_size() > 1


def shutdown() -> None:
    """Destroy the default process group, if one is up."""
    import torch.distributed as dist

    if is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def driver_group(logger=None, device=None):
    """A driver's process group: :func:`initialize` on entry (a topology
    line to ``logger`` when it forms more than one rank), destroyed on
    every exit path if this call brought it up.  Yields the world size."""
    created = not is_initialized()
    try:
        multi = initialize(device=device)
        if multi and logger is not None:
            logger.info("multi-process runtime: %d ranks (%s)", world_size(),
                        _backend(device))
        yield world_size()
    finally:
        if created:
            shutdown()


def global_data_mesh() -> DataGroup:
    """The default process group as a data mesh (same call on every
    rank)."""
    if not is_initialized():
        raise RuntimeError(
            "global_data_mesh needs an initialised torch.distributed "
            "process group (initialize)")
    return DataGroup()


def _process_row_bounds(
    n_global_rows: int, process_id: int, n_local_devices: int,
    process_count: int,
) -> Tuple[int, int]:
    """[start, stop) owned by one process under a 1-D row sharding: the
    reference's arithmetic — ceil-sized chunks per DEVICE (the last may be
    short or empty), each process owning its local devices' consecutive
    chunks.  A rank of the port has one card."""
    total = n_local_devices * process_count
    chunk = -(-n_global_rows // total)
    start = min(process_id * n_local_devices * chunk, n_global_rows)
    stop = min((process_id + 1) * n_local_devices * chunk, n_global_rows)
    return start, stop


def host_local_rows(n_global_rows: int) -> Tuple[int, int]:
    """This rank's contiguous ``[start, stop)`` block of a global row space
    — the block :func:`~photon_ml_tpu_torch.parallel.distributed
    .shard_glm_data` gives it (the full range without a group)."""
    if not is_initialized():
        return 0, n_global_rows
    import torch.distributed as dist

    return _process_row_bounds(n_global_rows, dist.get_rank(), 1,
                               dist.get_world_size())


_SPANS: dict = {}


def spans_hosts(mesh: Optional[DataGroup]) -> bool:
    """Whether the group's ranks run on more than one host (their host
    names all-gathered once a group; a collective, so every rank calls
    it).  The reference's single-host guards read this."""
    if mesh is None:
        return False
    key = id(mesh.group)
    if key not in _SPANS:
        import socket

        import torch.distributed as dist

        names = [None] * mesh.size
        dist.all_gather_object(names, socket.gethostname(), group=mesh.group)
        _SPANS[key] = len(set(names)) > 1
    return _SPANS[key]
