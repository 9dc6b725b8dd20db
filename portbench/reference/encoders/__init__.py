"""The reference's encoders, one file each, found by the configuration's
``encoder`` name: ``portbench/reference/encoders/<encoder>.py`` gives

- ``CHANNELS``: the widths of its five taps, at strides 2, 4, 8, 16, 32;
- ``features(m, x)``: those five taps of images ``x`` (B, 3, H, W),
  through the primitives of ``m`` (a ``reference.model.Model``: ``conv``,
  ``same_conv``, ``bn``, ``round``), the parameters read by the program's
  ``state_dict`` names;
- ``shapes(conv, bn)``: its parameters and BatchNorm buffers, declared in
  ``state_dict`` order through the two callbacks
  ``conv(name, out, in, kernel)`` and ``bn(name, channels)``;
- optionally ``bn_scale(name)``: the scale of the seeded weights of the
  BatchNorm ``name`` (1 where it is not given; ``harness/weights.py``).
"""

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def bn_scale(name: str):
    """The encoder's ``bn_scale``, or 1 for every BatchNorm."""
    return getattr(load(name), "bn_scale", lambda _: 1.0)
