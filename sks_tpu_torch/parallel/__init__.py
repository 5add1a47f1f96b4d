"""Multi-device layer on ``torch.distributed``: meshes, sharded RANSAC,
sharded refinement, bundle adjustment and pose graph.

Port of ``sks_tpu/parallel``: one process a device, the ranks laid out on a
named :class:`Mesh`; hypotheses split over the ranks for RANSAC, points for
the N-point solvers, landmarks for BA, edges for the pose graph; the
reductions are ``all_reduce`` and ``all_gather`` over the mesh's process
groups (NCCL between cards, gloo between CPU ranks).
"""

from sks_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from sks_tpu_torch.parallel.sharded_ransac import (  # noqa: F401
    sharded_ransac_homography,
)
from sks_tpu_torch.parallel.sharded_refine import (  # noqa: F401
    sharded_ho_h,
    sharded_ndlt_h,
)
from sks_tpu_torch.parallel.sharded_posegraph import (  # noqa: F401
    shard_graph,
    sharded_optimize_posegraph,
)
from sks_tpu_torch.parallel.distributed import (  # noqa: F401
    global_mesh,
    initialize_multihost,
    is_multiprocess,
    replicate_to_mesh,
)
