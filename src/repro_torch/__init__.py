"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It keeps the reference package's module names and serves the dense
decoder family end to end: ``serve.Engine`` over a paged KV pool, with
paged decode attention, prefill flash attention and RMSNorm as
hand-written CUDA kernels (``csrc/``, built on first use).  It imports
neither JAX nor the ``repro`` package.  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
