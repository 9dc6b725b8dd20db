"""kernels.lpg_roofline.train (%, device trace and counts): as
``kernels.lpg_roofline.serve``, K1 and K2 of the traced steps."""

from portbench.harness.manifest import reader

read = reader("kernels.lpg_roofline.serve")
