"""srgan_tpu_torch: the PyTorch / CUDA port of srgan_tpu for NVIDIA Hopper.

Importing the package builds no kernel and imports neither ``triton`` nor
anything of JAX or ``srgan_tpu``; the CUDA sources under ``csrc/`` are
compiled at first use by ``srgan_tpu_torch.ops.build``.
"""
