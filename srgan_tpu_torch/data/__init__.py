"""The data feed of the port (counterpart of ``srgan_tpu/data``): the
synthetic CelebA fixture, the attribute store, ``FaceDataset``, the native
decoder, ``DataLoader`` and ``prefetch_to_device``.  Importing it imports
no PIL and builds nothing."""

from srgan_tpu_torch.data.attributes import (  # noqa: F401
    build_label_folder,
    load_label_store,
    parse_attr_file,
)
from srgan_tpu_torch.data.dataset import (  # noqa: F401
    DEFAULT_DATASET_LABEL,
    FaceDataset,
)
from srgan_tpu_torch.data.loader import (  # noqa: F401
    DataLoader,
    prefetch_to_device,
)
from srgan_tpu_torch.data.sampling import (  # noqa: F401
    class_encode,
    get_class_label,
    get_target,
)
from srgan_tpu_torch.data.synthetic import (  # noqa: F401
    make_scale_attr_file,
    make_synthetic_celeba,
)
