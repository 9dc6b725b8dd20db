"""driver.enqueue_ms.train (ms, host clock): the mean host time of a call of
``Trainer.train_step`` until it returns, over the window's steps; the
arithmetic of ``driver.enqueue_ms.serve``."""

from portbench.harness.manifest import reader

read = reader("driver.enqueue_ms.serve")
