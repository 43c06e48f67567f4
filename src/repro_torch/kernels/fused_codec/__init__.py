from repro_torch.kernels.fused_codec.ops import (  # noqa: F401
    fused_codec, launches)
from repro_torch.kernels.fused_codec.ref import fused_codec_ref  # noqa: F401
