"""model.encoder_launches_per_image.train (launches, device trace): as
``model.encoder_launches_per_image.serve``, the forward of the traced steps."""

from portbench.harness.manifest import reader

read = reader("model.encoder_launches_per_image.serve")
