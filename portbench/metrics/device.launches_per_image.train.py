"""device.launches_per_image.train (launches, device trace): as
``device.launches_per_image.serve``, over the traced steps' images."""

from portbench.harness.manifest import reader

read = reader("device.launches_per_image.serve")
