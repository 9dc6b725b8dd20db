"""Published peaks, by ``torch.cuda.get_device_name()``: NVIDIA's data sheet
for the H100 SXM (dense, no sparsity), at its full power limit of 700 W.
A card set below that runs slower, so the run prints the power limit
beside every share of a peak."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12,  # FLOP/s, tensor cores
        "float32": 67e12,  # FLOP/s, CUDA cores (TF32 off, as the program runs float32)
        "hbm": 3.35e12,  # bytes/s
    },
}


def peak(device_name: str, key: str):
    """The peak, or None for a card the table does not hold."""
    return PEAKS.get(device_name, {}).get(key)
