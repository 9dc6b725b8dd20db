"""model.encoder_device_ms.train (ms, device trace): as
``model.encoder_device_ms.serve``, the forward of the traced steps (remat's
recompute runs in the backward and counts there)."""

from portbench.harness.manifest import reader

read = reader("model.encoder_device_ms.serve")
