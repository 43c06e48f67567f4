from repro_torch.kernels.dct8x8.ops import (  # noqa: F401
    dct8x8, idct8x8, launches)
from repro_torch.kernels.dct8x8.ref import (  # noqa: F401
    dct8x8_ref, idct8x8_ref)
