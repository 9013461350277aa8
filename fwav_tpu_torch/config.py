"""Encoder and decoder configuration (copied from fwav_tpu/config.py).

The fields and defaults are those of the JAX package, minus the two knobs
that only exist for its XLA/TPU transport: `use_pallas` (the port always
runs its CUDA kernels on a CUDA device and their plain versions on the CPU)
and `h2d_chunks` (tunnel upload pipelining).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

FWAV_VERSION = 1

#: Candidate domains per range in the embedding-shortlist search path.
TOP_K = 32

#: The decoder s_damping the damped encode profile is tuned for, stored as
#: the v2 container's decode hint (FLAG_DECODE_HINT) so that a hint-aware
#: decode realizes the profile's quality.
DAMPED_DECODE_DAMPING = 0.25

#: Fields of the JAX package's EncoderConfig that have no meaning here.
_REFERENCE_ONLY_FIELDS = ("use_pallas", "h2d_chunks")


def derive_range_size(tile_size: int) -> int:
    return max(4, tile_size // 256)


def derive_domain_step(range_size: int) -> int:
    return max(1, range_size // 4)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encode-side knobs; see fwav_tpu.config.EncoderConfig for the
    measurements behind each default."""

    tile_size: int = 1024
    emb_dim: int = 16
    top_k: int = TOP_K
    ef_search: int = 50
    energy_thresh: float = 1e-4
    fast_mode: bool = True
    transient_weight: float = 1.0
    n_mels: int = 40
    s_clip: float = 16.0
    #: "exact", "coarse", "topk" or "auto" ("coarse" for large banks).
    search: str = "auto"
    auto_coarse_threshold: int = 32768
    coarse_stride: int = 128
    coarse_topc: int = 1
    #: "balanced", "affine" or "damped".
    objective: str = "balanced"
    global_candidates: Optional[bool] = None
    global_stride: int = 512
    global_topc: int = 4
    domain_block: int = 2048
    range_block: int = 32768

    @property
    def range_size(self) -> int:
        return derive_range_size(self.tile_size)

    @property
    def domain_step(self) -> int:
        return derive_domain_step(self.range_size)

    @classmethod
    def from_reference(cls, d: dict) -> "EncoderConfig":
        """Build from `dataclasses.asdict()` of a fwav_tpu EncoderConfig, so
        both packages run the same settings. The JAX-only fields are
        dropped; any other unknown field raises."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names - set(_REFERENCE_ONLY_FIELDS)
        if unknown:
            raise ValueError(f"unknown EncoderConfig fields: {sorted(unknown)}")
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    iterations: int = 8
    convergence_eps: float = 1e-3
    s_clip: float = 16.0
    s_damping: float = 0.0
