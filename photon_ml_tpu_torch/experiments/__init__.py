"""The port's copies of the kernel design experiments under ``experiments/``.

The top-level ``experiments/`` directory holds the reference's JAX scripts,
which time the TPU kernels behind ``_tile_kernel``'s design.  Each module
here computes the same function with a hand-written CUDA kernel and times
it on the card:

- ``g8192``    — ``exp_g8192.py``: the ELL mat-vec gathering from an
                 8192-wide w (``csrc/ell_matvec.cu``), and its chain of
                 passes captured as one CUDA graph;
- ``g8192_v2`` — ``exp_g8192_v2.py``: the same mat-vec over the window
                 layout (``csrc/window_matvec.cu``);
- ``ablate``   — ``exp_ablate.py``: the SpMV row and column kernels with
                 the gather, then every read of x, taken away
                 (``csrc/spmv.cu``'s ``MODE``);
- ``row_block`` — the port's own probe: the column kernel's row block R,
                 chosen by timing the library built at each candidate R;
- ``window_ring`` — the port's own probe: the window kernel's tile, ring
                 depth and accumulator copies, chosen the same way, with
                 the read-only pass that gives its stream's ceiling;
- ``fleet_burst`` — the port's own probe: a fleet router's 16 workers
                 turning to one surviving HTTP host at once, repeated,
                 at a chosen listen backlog;
- ``serve_launch`` — the port's own probe: the serving kernel with its
                 request side in HBM and in page-locked host memory, a
                 bucket's round trip, the launch floor, a design sweep
                 (card only).

Run each as ``python -m photon_ml_tpu_torch.experiments.<name>``; the card
is the default, ``--device cpu`` runs the plain PyTorch versions.
"""
