from repro_torch.kernels.pack_bits.ops import launches, pack_bits  # noqa: F401
from repro_torch.kernels.pack_bits.ref import pack_bits_ref  # noqa: F401
