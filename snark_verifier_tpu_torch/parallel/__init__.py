from .batch_verify import batch_verify, batch_verify_sharded
from .mesh import Mesh
from .msm_sharded import batch_msm_sharded, msm_sharded

__all__ = ["Mesh", "batch_msm_sharded", "batch_verify", "batch_verify_sharded", "msm_sharded"]
