"""driver.input_device_ms.train (ms, device trace): as
``driver.input_device_ms.serve``, over the traced steps' images (the uploads
and the augmentation on the card)."""

from portbench.harness.manifest import reader

read = reader("driver.input_device_ms.serve")
