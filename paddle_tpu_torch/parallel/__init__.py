from .mesh import (DP_AXIS, EP_AXIS, MP_AXIS, PP_AXIS,  # noqa: F401
                   SP_AXIS, Mesh, MeshGuard, get_mesh, has_mesh, init_mesh,
                   make_mesh, mesh_axis_size)
from .train_step import TrainStep  # noqa: F401
