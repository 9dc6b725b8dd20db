"""kernels.lpg_heads_device_ms.train (ms, device trace): as
``kernels.lpg_heads_device_ms.serve``, the forward of the traced steps (K2,
in the backward, counts there)."""

from portbench.harness.manifest import reader

read = reader("kernels.lpg_heads_device_ms.serve")
