"""device.idle_pct.train (%, device trace and host clock): as
``device.idle_pct.serve``, per image of the training steps."""

from portbench.harness.manifest import reader

read = reader("device.idle_pct.serve")
