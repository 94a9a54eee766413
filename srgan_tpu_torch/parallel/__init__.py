"""Data parallel over ``torch.distributed`` (counterpart of
``srgan_tpu/parallel``): the rank's place in the process group
(``mesh.py``) and the batch-global losses as explicit all-reduces
(``collectives.py``).  Importing it joins no group."""

from srgan_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from srgan_tpu_torch.parallel.collectives import (  # noqa: F401
    all_reduce_sum,
    global_batch_kl,
    global_corrcoef_loss,
    global_diversification_loss,
    global_histogram_imitation,
    global_kl_loss,
    global_masked_lsgan_loss,
)
