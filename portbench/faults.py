"""Faults planted under the timed path, to show that the check catches
them.  Each driver (``portbench/drivers/<driver>.py``) declares the faults
that its cells can have, ``faults(traffic)``: a fault swaps one attribute
of the driver's module, its way into the program, for a broken version,
for the length of a ``with planted(module, name):`` block.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(module, name: str, traffic: dict):
    """``module``'s fault ``name``, as a cell with ``traffic`` can have it."""
    found = module.faults(traffic)
    if name not in found:
        raise ValueError(f"{module.__name__} declares no fault {name!r} for this traffic")
    attr, make = found[name]
    real = getattr(module, attr)
    setattr(module, attr, make(real))
    try:
        yield
    finally:
        setattr(module, attr, real)
