from repro_torch.kernels.ssd_chunk.ops import ssd_intra_chunk
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref
