"""tiler_tpu: a JAX rebuild of GliGli's TileMotion (GTM) video codec.

Encoder pipeline, bitstream, and decoder re-designed as batched JAX/XLA/Pallas
array programs over dense tile tensors, run on an NVIDIA GPU; see SURVEY.md
at the repo root for the structural map of the reference this mirrors.
"""

__version__ = '0.1.0'

from .config import EncoderConfig, FTQuality  # noqa: F401
