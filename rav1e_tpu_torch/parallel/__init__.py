from rav1e_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    sharded_frame_analysis,
    sharded_inter_analysis,
)

__all__ = ["Mesh", "make_mesh", "sharded_frame_analysis",
           "sharded_inter_analysis"]
