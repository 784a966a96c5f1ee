from repro_torch.kernels.delta_rotate.ops import (delta_cos_sin, delta_rotate,
                                                  delta_rotate_band,
                                                  splice_plan, splice_rotate)
from repro_torch.kernels.delta_rotate.ref import delta_rotate_ref
