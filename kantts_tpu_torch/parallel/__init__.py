"""Data, tensor, sequence and pipeline parallelism over ``torch.distributed``
(``mesh.py``, ``tp.py``, ``pp.py``), exporting what
``kantts_tpu/parallel/__init__.py`` exports, under the same names."""

from kantts_tpu_torch.parallel.mesh import (  # noqa: F401
    distributed_init,
    make_mesh_2d,
)
from kantts_tpu_torch.parallel.pp import (  # noqa: F401
    make_pipe_mesh,
    pipeline_apply,
    stack_layer_params,
)
