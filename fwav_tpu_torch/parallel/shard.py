"""Multi-device encode: compress_audio_sharded (the counterpart of
fwav_tpu/parallel/shard.py).

Two shardings on a (dp, tp) mesh, both running the production encode
program of models/encode.py; there is no second, sharded pipeline:

1. dp: each dp row of the mesh takes a contiguous slab of ranges, with no
   communication.
2. tp: for "exact" and "topk" each cell of a row builds and scans only its
   contiguous row shard of the bank, and the shards' winners merge in the
   single-device tie order (ops/search.py merge_shard_bests: the larger
   score, then the lower global row, then the original orientation). Under
   "coarse" tp splits the row's ranges instead: the coarse stage's bank is
   a strided view of the box-mean sequence that every cell derives from
   the replicated signal, so each cell runs the single-device program on
   its sub-slab.

Only the 3-byte selections leave the devices, and the host refit makes the
stored s, o, err and orientation, so the records are bit-equal to the
single-device encode at every (dp, tp).
"""

from __future__ import annotations

import numpy as np

from ..config import EncoderConfig
from .mesh import make_mesh


def compress_audio_sharded(signal, framerate, sampwidth, mesh=None, config=None,
                           device="cuda", **kwargs):
    """Encode one mono signal over a (dp, tp) mesh (every device of
    `device`'s kind by default: make_mesh(device=device)). The return
    contract of compress_audio_arrays, whose records it equals bit for bit;
    encoder knobs go through `config` or EncoderConfig(**kwargs). A mesh of
    one cell is the single-device encode on that cell's device."""
    from ..models.encode import _compress_fast

    del framerate, sampwidth  # not used by the encode; kept for API symmetry
    if mesh is None:
        mesh = make_mesh(device=device)
    cfg = config or EncoderConfig(**kwargs)
    signal = np.ascontiguousarray(np.asarray(signal, dtype=np.float32))
    return _compress_fast(signal, cfg, mesh)
