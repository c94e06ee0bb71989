"""thevc_tpu_torch — the codec's device path in PyTorch and CUDA.

A second package beside ``thevc_tpu``: the JAX package stays the
reference, and this one carries its device math to an NVIDIA GPU
(Hopper, sm_90a).  The host-only modules of ``thevc_tpu`` (CABAC parse,
headers, ``FrameModel``, the native C++ core, digests, YUV I/O, the
numpy ops) are imported, not copied; every function that ran through
``jax`` has a PyTorch twin here.

This package imports ``torch`` and never ``jax``.  It has two paths.
The all-intra Main decode:

1. host CABAC parse (native core, shared);
2. stage-1 residuals: dequant + inverse DCT/DST per TU size class
   (``ops.tq``; on a CUDA tensor the hand-written kernel in
   ``csrc/residual.cu``);
3. the native intra walk, reading the residual buffer
   (``decoder.recon``);
4. deblocking + SAO for a batch of pictures (``ops.filters``);
5. the MD5 picture digest against the stream's SEI.

Entry point: ``python -m thevc_tpu_torch.apps.decoder -b str.bin -o
rec.yuv [--device cuda]``.

The fast-RD all-intra encode (``--FastRD=1``): the reference encoder
runs with its open-loop decision pass replaced by the port's
(``encoder.fast_intra``: 35-mode predictions, the Hadamard SATD sweep in
``csrc/satd.cu``, a transform RD estimate through ``csrc/residual.cu``,
the quadtree DP), seamed in by ``encoder.top.device_decisions``.  Entry
point: ``python -m thevc_tpu_torch.apps.encoder <the reference encoder's
arguments> --FastRD=1 [--device cuda]``.
"""

__version__ = "0.1.0"
