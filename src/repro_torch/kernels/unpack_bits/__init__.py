from repro_torch.kernels.unpack_bits.ops import (  # noqa: F401
    TILE_BITS, launches, table_params, unpack_bits, unpack_words)
from repro_torch.kernels.unpack_bits.ref import (  # noqa: F401
    resolve, unpack_words_ref)
