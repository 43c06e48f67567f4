from repro_torch.kernels.symbolize.ops import (  # noqa: F401
    PreparedStream, launches, symbolize)
from repro_torch.kernels.symbolize.ref import symbolize_ref  # noqa: F401
