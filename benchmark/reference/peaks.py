"""Published peaks of the NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit), by ``torch.cuda.get_device_name()``."""

PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 66.9e12},
}
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12


def peak_flops(card: str, dtype: str) -> float | None:
    return PEAK_FLOPS.get(card, {}).get(dtype)
