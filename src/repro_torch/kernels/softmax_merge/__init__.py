from repro_torch.kernels.softmax_merge.ops import softmax_merge
from repro_torch.kernels.softmax_merge.ref import softmax_merge_ref
