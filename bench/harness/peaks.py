"""The card's peaks, from the data sheet (dense rates, full power)."""
from __future__ import annotations

#: device name (``torch.cuda.get_device_name()``) -> peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,       # dense, tensor cores
        "f32_flops": 67e12,         # CUDA cores
        "hbm_bytes_s": 3.35e12,
    },
}


def peaks(device_name: str) -> dict:
    """The peaks of ``device_name``; an H100 SXM's for another H100."""
    if device_name in PEAKS:
        return PEAKS[device_name]
    if "H100" in device_name:
        return PEAKS["NVIDIA H100 80GB HBM3"]
    raise KeyError(f"no peaks for {device_name!r}")


def bound_seconds(flops: float, nbytes: float, device_name: str,
                  tensor_cores: bool = True) -> float:
    """The least time the card needs: the larger of the compute and the
    memory bound."""
    pk = peaks(device_name)
    rate = pk["bf16_flops"] if tensor_cores else pk["f32_flops"]
    return max(flops / rate, nbytes / pk["hbm_bytes_s"])
