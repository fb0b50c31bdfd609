"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It keeps the reference package's module names and serves the dense
decoder family end to end: ``serve.Engine`` over a paged KV pool (one
tenant, or several sharing one pool under ``serve.PoolArbiter``, built
locally or from a ``pool`` lease), with paged decode attention, prefill
flash attention and RMSNorm as hand-written CUDA kernels (``csrc/``,
built on first use); the mamba2 and zamba2 families through the
fixed-batch steps, with the SSD scan kernel.  It imports
neither JAX nor the ``repro`` package.  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
