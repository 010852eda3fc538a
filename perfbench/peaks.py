"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full 700 W): 989
TFLOP/s in bf16 and fp16, 1,979 in fp8 and int8, 495 in TF32, 67 in
float32 outside the tensor cores; 80 GB of HBM3 at 3.35 TB/s.
"""

from __future__ import annotations

PEAKS = {
    "H100": {"bfloat16": 989e12, "float16": 989e12, "float8": 1979e12, "int8": 1979e12,
             "tf32": 495e12, "float32": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def for_device(kind: str) -> dict | None:
    """The peaks of a card by its `torch.cuda.get_device_name()`, or None
    for a device this table does not know (the CPU among them)."""
    for family, peaks in PEAKS.items():
        if family in kind:
            return peaks
    return None

