"""openpbso_tpu — an accelerator-native physics-based modal sound framework.

A from-scratch JAX/XLA re-design of the capabilities of openpbso
(the KleinPAT runtime): real-time rigid-body impact/contact sound synthesis
from precomputed eigenmodes, modal materials, and FFAT acoustic-transfer maps.

Layer map:

- ``io``       file formats (.modes, material txt, .fatcube protobuf, .meta)
- ``ops``      device math: modal bank, block integrator backends, force
               profile synthesis, FFAT cubemap lookup
- ``models``   model/scene assembly (mesh + modes + material + maps)
- ``runtime``  the block solver, host session, streaming engine, audio IO
- ``parallel`` multi-device sharding (mesh + shard_map block step)
- ``utils``    float64 oracle, synthetic assets, profiling
- ``apps``     CLI tools mirroring the reference binaries
"""
from . import config
from .config import (DEFAULT_BLOCK, FRAMES_PER_BUFFER, MODAL_GAIN,
                     OUTPUT_SCALE, SAMPLE_RATE, UNIT_TRANSFER)

__version__ = "0.1.0"
