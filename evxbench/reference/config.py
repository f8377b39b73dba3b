"""Copy of cairo_tpu.config: the runtime codec configuration."""

from __future__ import annotations

import dataclasses

from . import tables


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    # wire-format fields (header-checked / stream-visible)
    reference_frame_count: int = tables.REFERENCE_FRAME_COUNT  # config.h:39
    enable_chroma: bool = True                                 # config.h:42

    # behavioral fields (must match on both ends, like config.h)
    default_quality: int = tables.DEFAULT_QUALITY              # config.h:40
    periodic_intra_rate: int = tables.PERIODIC_INTRA_RATE      # config.h:41
    enable_inter_frames: bool = True                           # config.h:38
    quantization_enabled: bool = True                          # config.h:47
    linear_quantization: bool = False                          # config.h:48
    rounded_quantization: bool = True                          # config.h:49
    adaptive_quantization: bool = True                         # config.h:50
    enable_deblocking: bool = True                             # config.h:53

    def __post_init__(self):
        if not 1 <= self.reference_frame_count <= 4:
            raise ValueError("reference_frame_count must be 1..4")
        if not 1 <= self.default_quality <= 31:
            raise ValueError("default_quality must be 1..31")
        if self.periodic_intra_rate < 0:
            raise ValueError("periodic_intra_rate must be >= 0")

    @property
    def is_conformance(self) -> bool:
        return self == CONFORMANCE

    @property
    def tpu_supported(self) -> bool:
        """True if the TPU fast path implements this combination."""
        return (self.enable_chroma and self.quantization_enabled
                and not self.linear_quantization
                and self.rounded_quantization)


#: Reference defaults — bit-exact conformance mode.
CONFORMANCE = CodecConfig()
