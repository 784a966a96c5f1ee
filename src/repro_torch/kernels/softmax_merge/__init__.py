from repro_torch.kernels.softmax_merge.ops import (MAX_PARTS, softmax_merge,
                                                   softmax_merge_parts)
from repro_torch.kernels.softmax_merge.ref import softmax_merge_ref
