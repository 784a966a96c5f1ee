from repro_torch.kernels.sparse_select.ops import sparse_select
from repro_torch.kernels.sparse_select.ref import sparse_select_ref
