"""model.decoder_device_ms.train (ms, device trace): as
``model.decoder_device_ms.serve``, the forward of the traced steps."""

from portbench.harness.manifest import reader

read = reader("model.decoder_device_ms.serve")
