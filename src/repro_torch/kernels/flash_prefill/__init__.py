from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
