from repro_torch.kernels.cordic_loeffler.ops import (  # noqa: F401
    cordic_loeffler_dct, cordic_loeffler_idct, launches)
from repro_torch.kernels.cordic_loeffler.ref import (  # noqa: F401
    cordic_loeffler_ref)
