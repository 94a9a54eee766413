"""PRDC evaluation over VGG19-BN features (counterpart of
``srgan_tpu/evaluation``).  Importing it builds nothing and imports no
PIL."""

from srgan_tpu_torch.evaluation.prdc import compute_prdc  # noqa: F401
from srgan_tpu_torch.evaluation.features import (  # noqa: F401
    VGG19BN,
    vgg_feature_extractor,
)
from srgan_tpu_torch.evaluation.harness import (  # noqa: F401
    GANEvaluation,
    evaluation_init,
)
