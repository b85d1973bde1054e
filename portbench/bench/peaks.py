"""Published peaks of the cards the benchmark runs on.

NVIDIA's H100 SXM data sheet (dense, no sparsity), at the full 700 W
limit: HBM3 at 3.35 TB/s, 67 TFLOP/s in float32 outside the tensor cores.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}


def peaks_for(kind: str) -> dict | None:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card not in the table."""
    return PEAKS.get(kind)
