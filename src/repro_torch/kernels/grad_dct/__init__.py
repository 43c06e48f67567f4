from repro_torch.kernels.grad_dct.ops import (  # noqa: F401
    BLOCK, CompressedGrad, decode, default_block_rows, encode, launches,
    roundtrip)
from repro_torch.kernels.grad_dct.ref import (  # noqa: F401
    grad_dct_decode_ref, grad_dct_encode_ref, grad_dct_roundtrip_ref)
