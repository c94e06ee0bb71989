"""thevc_tpu_torch — the codec's device path in PyTorch and CUDA.

A second package beside ``thevc_tpu``: the JAX package stays the
reference, and this one carries its device math to an NVIDIA GPU
(Hopper, sm_90a).  It stands alone: the host codec it runs around the
device (CABAC, headers and NAL units, ``FrameModel``, the native C++
core, digests, YUV I/O, cfg parsing, the numpy ops, the encoder's exact
path) is its own copy of the JAX package's host modules, at the same
relative paths, with the branches that reached ``jax`` taken out; every
function that ran through ``jax`` has a PyTorch twin here.

This package imports ``torch`` and never ``jax``, and nothing of
``thevc_tpu``.  Its device paths:

The all-intra Main decode:

1. host CABAC parse (the native core);
2. stage-1 residuals: dequant + inverse DCT/DST per TU size class
   (``ops.tq``; on a CUDA tensor the hand-written kernel in
   ``csrc/residual.cu``, which also unpacks the coded coefficient
   groups);
3. the native intra walk, reading the residual buffer
   (``decoder.recon``);
4. deblocking + SAO for a batch of pictures (``ops.filters``);
5. the MD5 picture digest against the stream's SEI.

Entry point: ``python -m thevc_tpu_torch.apps.decoder -b str.bin -o
rec.yuv [--device cuda]``.

P and B pictures add motion compensation on the device
(``decoder.inter``, ``ops.mc``, with weighted prediction); pictures with
scaling lists dequantise per coefficient on the device.

The fast-RD encode (``--FastRD=1``): the encoder runs its open-loop
decision passes on the device that ``encoder.top.Encoder`` is given
(``encoder.fast_intra``: 35-mode predictions, the Hadamard SATD sweep in
``csrc/satd.cu``, a transform RD estimate through ``csrc/residual.cu``,
the quadtree DP; ``encoder.fast_inter`` for P and B slices: a coarse
full search, integer and quarter-pel refinement with the same SATD
kernel, RD leaves through the residual kernel, merge/skip and
bi-prediction models).  Entry point: ``python -m
thevc_tpu_torch.apps.encoder <TAppEncoder's arguments> --FastRD=1
[--device cuda]``; without ``--FastRD=1`` it is the exact path on the
host, byte-identical to the JAX package's encoder.
"""

__version__ = "0.1.0"
