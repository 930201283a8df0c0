"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates): the yardstick of every roofline and mfu share."""
from __future__ import annotations

PEAKS = {
    "H100": {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
             "float32": 67e12, "bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict:
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    raise KeyError(f"no published peaks for {device_name!r}")


def flops_peak(device_name: str, dtype: str) -> float:
    return peaks(device_name)[dtype]


def bytes_peak(device_name: str) -> float:
    return peaks(device_name)["bytes_per_s"]
