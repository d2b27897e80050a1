"""The port's process-group bring-up (``parallel/multihost.py``) against the
JAX package's ``parallel/multihost.py``: the same environment handling, the
same row-block arithmetic."""

import numpy as np
import pytest

from photon_ml_tpu.parallel import multihost as ref_mh
from photon_ml_tpu_torch.parallel import multihost
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

ENV = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "NUM_PROCESSES",
       "JAX_NUM_PROCESSES", "PROCESS_ID", "JAX_PROCESS_ID",
       "PHOTON_MULTIHOST")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    multihost.shutdown()


@pytest.mark.parametrize("env", [
    {},
    # Unprefixed counts are common in unrelated tooling: without a
    # coordinator address they show no intent and are ignored.
    {"NUM_PROCESSES": "4", "PROCESS_ID": "1"},
    # A launcher's variables count only under PHOTON_MULTIHOST=1.
    {"PHOTON_MULTIHOST": "0"},
], ids=["empty", "unprefixed-counts", "multihost-off"])
def test_no_config_is_a_no_op(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert multihost.initialize(device="cpu") is False
    assert ref_mh.initialize() is False
    assert not multihost.is_initialized()
    assert multihost.world_size() == 1


@pytest.mark.parametrize("env", [
    {"COORDINATOR_ADDRESS": "localhost:1234"},
    {"JAX_COORDINATOR_ADDRESS": "localhost:1234", "NUM_PROCESSES": "2"},
    {"JAX_NUM_PROCESSES": "2"},
    {"COORDINATOR_ADDRESS": "localhost:1234", "JAX_PROCESS_ID": "0"},
], ids=["address-only", "no-process-id", "count-only", "no-count"])
def test_partial_config_fails_loudly(clean_env, env):
    """A partial config is a deployment bug in both packages: a pointed
    ValueError, never a hang or a silent single-process run."""
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError, match="needs ALL"):
        multihost.initialize(device="cpu")
    with pytest.raises(ValueError, match="needs ALL"):
        ref_mh.initialize()
    assert not multihost.is_initialized()


def test_full_config_brings_up_a_gloo_group(clean_env, tmp_path):
    """The three variables (a file:// rendezvous here) bring up a gloo
    group on the CPU; one rank is not multi-process, and the group is
    kept by a second call."""
    clean_env.setenv("COORDINATOR_ADDRESS", f"file://{tmp_path}/rdv")
    clean_env.setenv("NUM_PROCESSES", "1")
    clean_env.setenv("PROCESS_ID", "0")
    assert multihost.initialize(device="cpu") is False
    assert multihost.is_initialized()
    import torch.distributed as dist

    assert dist.get_backend() == "gloo"
    assert multihost.initialize(device="cpu") is False
    assert multihost.global_data_mesh().size == 1
    assert multihost.host_local_rows(10) == (0, 10)


def test_driver_group_destroys_only_what_it_created(clean_env, tmp_path):
    with multihost.driver_group(device="cpu") as world:
        assert world == 1 and not multihost.is_initialized()
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", f"file://{tmp_path}/rdv")
    clean_env.setenv("JAX_NUM_PROCESSES", "1")
    clean_env.setenv("JAX_PROCESS_ID", "0")
    with multihost.driver_group(device="cpu") as world:
        assert world == 1 and multihost.is_initialized()
    assert not multihost.is_initialized()
    multihost.initialize(device="cpu")
    with multihost.driver_group(device="cpu"):
        pass
    assert multihost.is_initialized()


@pytest.mark.parametrize("n_rows", [0, 1, 7, 100, 101, 1 << 20])
@pytest.mark.parametrize("processes,local", [(1, 1), (2, 1), (4, 1), (3, 2),
                                             (8, 4)])
def test_process_row_bounds_match_reference(monkeypatch, n_rows, processes,
                                            local):
    """The reference's ceil-chunk-per-device arithmetic, process by
    process; the blocks tile [0, n) in order."""
    monkeypatch.setattr(ref_mh.jax, "process_count", lambda: processes)
    bounds = [multihost._process_row_bounds(n_rows, p, local, processes)
              for p in range(processes)]
    assert bounds == [ref_mh._process_row_bounds(n_rows, p, local)
                      for p in range(processes)]
    flat = np.concatenate([np.arange(a, b) for a, b in bounds])
    assert flat.tolist() == list(range(n_rows))


def test_host_local_rows_without_a_group_is_the_full_range(clean_env):
    assert multihost.host_local_rows(37) == ref_mh.host_local_rows(37) == (
        0, 37)
