from repro_torch.kernels.mla_decode.ops import mla_decode
from repro_torch.kernels.mla_decode.ref import mla_decode_ref
