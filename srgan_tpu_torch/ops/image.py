"""Image and value conversions (counterpart of ``srgan_tpu/ops/image.py``).

The reference's ``min_max`` / ``MinMax`` / ``image_from_output``
(util.py:108-191).  The data feed normalises every image by its own min and
max to [-1, 1], not by a fixed mean and standard deviation.
"""

from __future__ import annotations

import numpy as np
import torch


def min_max(x, axis=None, mean0: bool = False, get_param: bool = False):
    """Min-max normalise to [0, 1], or to [-1, 1] with ``mean0``
    (util.py:108-116).  ``x`` is a numpy array or a torch tensor; the result
    is of the same kind."""
    if isinstance(x, torch.Tensor):
        dims = tuple(range(x.dim())) if axis is None else axis
        mn = torch.amin(x, dim=dims, keepdim=True)
        mx = torch.amax(x, dim=dims, keepdim=True)
    else:
        mn = x.min(axis=axis, keepdims=True)
        mx = x.max(axis=axis, keepdims=True)
    result = (x - mn) / (mx - mn + 1e-8)
    if mean0:
        result = result * 2 - 1
    if get_param:
        return result, mn, mx
    return result


def minmax_transform(img: np.ndarray, mean0: bool = True) -> np.ndarray:
    """The ``MinMax`` dataset transform (util.py:148-155): one min-max over
    all channels and pixels of the image, to [-1, 1]."""
    return np.asarray(min_max(np.asarray(img, np.float32), mean0=mean0),
                      np.float32)


def to_uint8_images(batch_nhwc) -> np.ndarray:
    """Model outputs (B, H, W, C) or (H, W, C), float, as displayable
    (B, H, W, 3) uint8 images, as ``image_from_output`` (util.py:157-191)
    makes them: each image min-maxed again to [0, 1], times 256, clipped at
    255; grayscale tiled to 3 channels.  Takes numpy or a CPU tensor."""
    if isinstance(batch_nhwc, torch.Tensor):
        batch_nhwc = batch_nhwc.detach().float().numpy()
    arr = np.asarray(batch_nhwc, np.float32)
    if arr.ndim == 3:
        arr = arr[None]
    out = []
    for a in arr:
        if a.shape[-1] != 3:
            a = np.tile(a, (1, 1, 3 // a.shape[-1]))
        a = np.asarray(min_max(a)) * 2**8
        out.append(np.clip(a, 0, 255).astype(np.uint8))
    return np.stack(out)


def nchw_on(images_nhwc, device) -> torch.Tensor:
    """(B, H, W, C) images (numpy or a tensor) as a contiguous fp32
    (B, C, H, W) tensor on ``device``: the data feed's layout to the
    models'."""
    return torch.as_tensor(images_nhwc, dtype=torch.float32,
                           device=device).permute(0, 3, 1, 2).contiguous()


def to_pil(img_chw_or_hwc):
    """One image, HWC or CHW float, as a PIL image, min-maxed for display as
    ``image_from_output`` does (the ``ToPIL`` transform, util.py:118-146)."""
    from PIL import Image

    if isinstance(img_chw_or_hwc, torch.Tensor):
        img_chw_or_hwc = img_chw_or_hwc.detach().float().numpy()
    arr = np.asarray(img_chw_or_hwc)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = np.transpose(arr, (1, 2, 0))
    return Image.fromarray(to_uint8_images(arr[None])[0])
