"""Data and context parallel training (counterpart of
``lina_speech_tpu.parallel``): the rank grid and its process groups
(``mesh.py``), starting the world (``multihost.py``), the collectives
(``collectives.py``), each rank's part of a batch (``sharding.py``) and
consistency checks (``checks.py``)."""
from lina_speech_tpu_torch.parallel.mesh import Mesh, MeshConfig, make_mesh
from lina_speech_tpu_torch.parallel.multihost import (
    distributed_init, make_multihost_mesh, process_batch_slice,
)
from lina_speech_tpu_torch.parallel.sharding import replicate_params, shard_batch
