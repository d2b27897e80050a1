"""The serving runtime's prebuilt launch (``serving/kernels.py::Coords``,
``ScoringRuntime._staging_buffers``) on the CPU.

On the card a bucket is one launch from a block built once per (runtime,
bucket): these tests hold its fields against ``launch_args`` (the C
arguments of the per-call route), pin that a patched or swapped runtime
never launches through its base's block, and that a CPU runtime still
scores through the plain version, bitwise, within 1e-6 of Σ|x·w| of the
reference's fused bucket program.  The launches themselves run only on
the card (tests/test_torch_gpu.py).
"""

from __future__ import annotations

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.serving import kernels as ref_kernels
from photon_ml_tpu_torch.io.game_store import save_game_model
from photon_ml_tpu_torch.serving import kernels
from photon_ml_tpu_torch.serving.batcher import BatcherConfig
from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
from photon_ml_tpu_torch.serving.service import ScoringService
from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

MAX_BATCH = 16
LADDER = (1, 2, 4, 8, 16)


@pytest.fixture(scope="module")
def workload():
    return SyntheticWorkload(n_entities=32, fixed_dim=40, re_dim=5, seed=11,
                             unknown_rate=0.1)


def _runtime(workload, **kwargs):
    cfg = RuntimeConfig(**{"max_batch_size": MAX_BATCH, "hot_entities": 8,
                           "device": "cpu", **kwargs})
    return ScoringRuntime(workload.model, workload.index_maps, cfg)


def _read(ptr, ctype, n):
    return list(ctypes.cast(ptr, ctypes.POINTER(ctype))[:n])


def _block_pointers(block):
    """Every pointer a block hands the kernel, by field."""
    out = {"offset": block.offset, "out": block.out}
    for name in ("fx", "fw"):
        out[name] = list(getattr(block, name)[:block.n_fixed])
    for name in ("rx", "rcold", "rtable", "rslot"):
        out[name] = list(getattr(block, name)[:block.n_random])
    return out


class TestLaunchBlock:
    @pytest.mark.parametrize("bucket", LADDER)
    @pytest.mark.parametrize("fused", [True, False],
                             ids=["fused", "composed"])
    def test_block_fields_equal_launch_args(self, workload, fused, bucket):
        """The prebuilt block carries exactly what ``launch_args`` passes
        the per-call route for the same operands: pointers, row strides,
        widths, the link and the row count."""
        rt = _runtime(workload, fused=fused)
        assert bucket in rt.buckets
        st = rt._staging_buffers(bucket)
        offset, fixed, random = rt._operands(*st.tensors[:2])
        a = kernels.launch_args(offset, fixed, random, rt._link,
                                st.tensors[2])
        c = st.block
        nf, nr = a[2], a[7]
        assert (nf, nr) == (1, 1)
        assert (c.offset, c.offset_stride) == (a[0], a[1])
        assert (c.n_fixed, c.n_random, c.link, c.n, c.out) == (
            nf, nr, a[15], a[17], a[16])
        assert a[17] == bucket and a[1] == rt._packed_width
        assert list(c.fx[:nf]) == _read(a[3], ctypes.c_void_p, nf)
        assert list(c.fx_stride[:nf]) == _read(a[4], ctypes.c_longlong, nf)
        assert list(c.fw[:nf]) == _read(a[5], ctypes.c_void_p, nf)
        assert list(c.fd[:nf]) == _read(a[6], ctypes.c_int, nf) == [40]
        assert list(c.rx[:nr]) == _read(a[8], ctypes.c_void_p, nr)
        assert list(c.rx_stride[:nr]) == _read(a[9], ctypes.c_longlong, nr)
        assert list(c.rcold[:nr]) == _read(a[10], ctypes.c_void_p, nr)
        assert list(c.rcold_stride[:nr]) == _read(a[11], ctypes.c_longlong,
                                                  nr)
        assert list(c.rtable[:nr]) == _read(a[12], ctypes.c_void_p, nr)
        assert list(c.rslot[:nr]) == _read(a[13], ctypes.c_void_p, nr)
        assert list(c.rd[:nr]) == _read(a[14], ctypes.c_int, nr) == [5]
        # The block is built once: the same object batch after batch.
        rows = [rt.parse_request(workload.request(i)) for i in range(bucket)]
        rt.score_rows(rows)
        assert rt._staging_buffers(bucket).block is c

    def test_fused_and_composed_blocks_agree(self, workload):
        """The two layouts' blocks name the same places: every pointer at
        the same offset into the same buffer or model tensor, every other
        field equal."""
        rts = [_runtime(workload, fused=f) for f in (True, False)]
        for b in LADDER:
            seen = []
            for rt in rts:
                st = rt._staging_buffers(b)
                bases = dict(zip(("packed", "slots", "out"),
                                 (t.data_ptr() for t in st.tensors)))
                bases["means"] = rt.fixed[0].means.data_ptr()
                bases["table"] = rt.random[0].hot.table.data_ptr()
                ends = dict(zip(("packed", "slots", "out"),
                                (t.data_ptr() + t.nbytes
                                 for t in st.tensors)))

                def where(p, bases=bases, ends=ends):
                    for name, lo in bases.items():
                        if lo <= p < ends.get(name, lo + 1):
                            return name, p - lo
                    raise AssertionError(p)

                rel = {k: [where(p) for p in (v if isinstance(v, list)
                                              else [v])]
                       for k, v in _block_pointers(st.block).items()}
                c = st.block
                rest = (c.offset_stride, c.n_fixed, c.n_random, c.link, c.n,
                        list(c.fx_stride), list(c.fd), list(c.rx_stride),
                        list(c.rcold_stride), list(c.rd))
                seen.append((rel, rest))
            assert seen[0] == seen[1], b

    def test_block_points_into_its_own_buffers(self, workload):
        """Request-side pointers lie in the bucket's staging buffers, the
        model side on the runtime's means and hot table."""
        rt = _runtime(workload)
        for b in LADDER:
            st = rt._staging_buffers(b)
            packed, slots, out = st.tensors
            c = st.block
            lo, hi = packed.data_ptr(), packed.data_ptr() + packed.nbytes
            for p in (c.offset, c.fx[0], c.rx[0], c.rcold[0]):
                assert lo <= p < hi
            assert c.rslot[0] == slots.data_ptr()
            assert c.out == out.data_ptr()
            assert c.fw[0] == rt.fixed[0].means.data_ptr()
            assert c.rtable[0] == rt.random[0].hot.table.data_ptr()

    def test_hot_flush_keeps_the_blocks_table(self, workload):
        """Promotions write the hot table in place, so the block's table
        pointer stays valid batch after batch."""
        rt = _runtime(workload)
        table = rt.random[0].hot.table
        ptr = table.data_ptr()
        for start in range(0, 48, 8):
            rt.score_rows([rt.parse_request(workload.request(i))
                           for i in range(start, start + 8)])
        assert rt.random[0].hot.inserts > 0
        assert rt.random[0].hot.table is table
        assert table.data_ptr() == ptr
        assert rt._staging_buffers(8).block.rtable[0] == ptr

    def test_coords_mirrors_the_c_struct(self):
        """The ctypes mirror keeps C's layout rules: 8-byte pointers and
        long longs on 8-byte boundaries, the arrays in the source's
        order (the library checks sizeof and the offsets on the card)."""
        f = kernels.Coords
        assert f.n.offset == 32 and f.out.offset == 40 and f.fx.offset == 48
        assert f.rd.offset == f.rslot.offset + 8 * kernels.MAX_RANDOM
        assert ctypes.sizeof(f) % 8 == 0
        assert ctypes.sizeof(f) == f.rd.offset + 4 * kernels.MAX_RANDOM


class TestOwnBlocks:
    @pytest.mark.parametrize("how", ["patched", "swapped"])
    def test_new_runtime_never_launches_through_the_base_block(
            self, workload, tmp_path, how):
        base = _runtime(workload)
        rows = [base.parse_request(workload.request(i)) for i in range(16)]
        base.score_rows(rows)
        if how == "patched":
            new = ScoringRuntime.patched(base, workload.model,
                                         workload.index_maps)
            new.score_rows(rows)
        else:
            path = str(tmp_path / "v2")
            save_game_model(workload.model, workload.index_maps, path)
            with ScoringService(base, BatcherConfig(
                    max_batch_size=MAX_BATCH, max_wait_us=500)) as service:
                assert service.reload(path).status == "swapped"
                new = service.current_runtime
                service.score_many([workload.request(i) for i in range(16)])
        assert new is not base
        base_ptrs = set()
        for b in LADDER:
            base_ptrs.update(
                p for v in _block_pointers(base._staging_buffers(b).block)
                .values() for p in (v if isinstance(v, list) else [v]))
        for b in LADDER:
            st = new._staging_buffers(b)
            ptrs = _block_pointers(st.block)
            flat = [p for v in ptrs.values()
                    for p in (v if isinstance(v, list) else [v])]
            assert not base_ptrs.intersection(flat), b
            assert ptrs["rtable"] == [new.random[0].hot.table.data_ptr()]
            assert ptrs["fw"] == [new.fixed[0].means.data_ptr()]
            assert st.block is not base._staging_buffers(b).block


class TestCpuRuntimeScoresPlain:
    def test_scores_through_the_plain_version_bitwise(self, workload,
                                                      monkeypatch):
        """Every CPU batch goes through ``serve_margins_plain`` on the
        bucket's staging buffers, its scores are that call's bits, and the
        reference's fused program on the same arrays is within 1e-6 of
        Σ|x·w|."""
        seen = []
        inner = kernels.serve_margins_plain

        def spy(offset, fixed, random, link):
            out = inner(offset, fixed, random, link)
            packed, slots, _ = rt._staging_buffers(offset.shape[0]).tensors
            assert fixed[0][0].data_ptr() == packed.data_ptr() + 4
            seen.append(dict(packed=packed.clone(), slots=slots.clone(),
                             w=fixed[0][1].clone(),
                             table=random[0][1].clone(), link=link,
                             out=out.clone()))
            return out

        rt = _runtime(workload)
        monkeypatch.setattr(kernels, "serve_margins_plain", spy)
        ref = ref_kernels.build_fused_bucket_kernel(
            ref_losses.get(workload.model.task).mean_fn)
        got = []
        for n in (1, 3, 8, 16, 5, 16):
            rows = [rt.parse_request(workload.request(i)) for i in range(n)]
            got.append((n, rt.score_rows(rows)))
        assert len(seen) == len(got)
        for (n, (margins, means)), call in zip(got, seen):
            again = inner(*kernels.fused_operands(
                call["packed"], call["slots"], (call["w"],),
                (call["table"],)), call["link"])
            assert again.numpy().tobytes() == call["out"].numpy().tobytes()
            assert margins.tobytes() == call["out"][0, :n].numpy().tobytes()
            assert means.tobytes() == call["out"][1, :n].numpy().tobytes()
            r = np.asarray(ref(jnp.asarray(call["packed"].numpy()),
                               jnp.asarray(call["slots"].numpy()),
                               (jnp.asarray(call["w"].numpy()),),
                               (jnp.asarray(call["table"].numpy()),)))
            p = call["packed"].numpy().astype(np.float64)
            d = call["w"].shape[0]
            x_f = p[:, 1:1 + d]
            x_r, cold = p[:, 1 + d:6 + d], p[:, 6 + d:11 + d]
            coefs = call["table"].numpy()[call["slots"][0].numpy()] + cold
            scale = (np.abs(p[:, 0]) + np.abs(x_f * call["w"].numpy()).sum(1)
                     + np.abs(x_r * coefs).sum(1))
            err = np.abs(r[0] - call["out"][0].numpy()) / np.maximum(
                scale, 1e-30)
            assert float(err.max()) <= 1e-6
            np.testing.assert_allclose(r[1], call["out"][1].numpy(),
                                       rtol=1e-6, atol=1e-7)
