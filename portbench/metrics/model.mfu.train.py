"""model.mfu.train (%, host clock and counts): as ``model.mfu.serve``, a
training step's FLOPs per image being three forwards'."""

from portbench.harness.manifest import reader

read = reader("model.mfu.serve")
