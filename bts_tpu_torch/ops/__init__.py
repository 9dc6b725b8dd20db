from bts_tpu_torch.ops.lpg import (  # noqa: F401
    local_planar_guidance,
    lpg_reference,
    lpg_scaled_from_raw,
    lpg_strided,
    plane_from_spherical,
)
from bts_tpu_torch.ops.lpg_cuda import lpg_fused, lpg_fused_plain  # noqa: F401
from bts_tpu_torch.ops.resize import downsample_nearest, upsample_nearest_2x  # noqa: F401
from bts_tpu_torch.ops import tail_cuda  # noqa: F401  (registers K5's and K6's ops)
from bts_tpu_torch.ops import bn_cuda  # noqa: F401  (registers K7's op)
