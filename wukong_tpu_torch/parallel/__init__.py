from wukong_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from wukong_tpu_torch.parallel.dist_engine import DistEngine  # noqa: F401
