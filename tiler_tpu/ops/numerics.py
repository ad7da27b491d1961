"""The numerics contract: the precision of every float32 matmul whose
argmin or argmax decides the stream.

A float32 matmul at default precision may run in TF32 on an NVIDIA GPU,
which keeps about three decimal digits and moves which candidate wins a
nearest-neighbour argmin, so it changes the stream. Every such product
(1-NN and k-NN distances, PsyV features, k-means distances and seeding)
takes its precision from `stream_precision()` and nothing
else. On the GPU that is three-pass TF32 (`TF32_TF32_F32_X3`): float32-
equivalent accuracy on the tensor cores. XLA:CPU refuses that algorithm
and computes float32 matmuls in IEEE float32 anyway, so the CPU gets
`Precision.HIGHEST`.

Products that are exact in any precision do not need the pin, and say so
where they are made: the KModes one-hot dissimilarity and category counts
(0/1 operands and small integers, exact in bf16 with f32 accumulation)
and the Knoll dither's cumulative counts (0/1 times small integers).

docs/PARITY.md states what this buys: byte-identical streams across runs
and across device counts on one platform, and a bounded PSNR and size gap
between the GPU and the CPU.
"""
from __future__ import annotations

import jax
from jax import lax

GPU_PRECISION = lax.DotAlgorithmPreset.TF32_TF32_F32_X3


def _platform() -> str:
    return jax.default_backend()


def stream_precision():
    """Precision for a stream-deciding float32 matmul on this backend."""
    if _platform() == 'gpu':
        return GPU_PRECISION
    return lax.Precision.HIGHEST
