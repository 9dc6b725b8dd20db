"""The loops that a window drives, one file per kind of traffic, found by
the ``driver`` that a traffic file names: ``portbench/drivers/<driver>.py``
gives

- ``Driver(model_cfg, traffic, seeds, device)``: ``kind`` (the family of
  metrics its record feeds, "serve" or "train"), ``setup()``,
  ``window(seconds)`` and ``traced()`` (records for the metrics),
  ``heads()`` (batch, height, width of one forward, for the counts),
  ``free()`` and ``check()`` (the compared numbers);
- ``faults(traffic)``: the faults that such a cell can have, the grossest
  first, each ``name -> (attribute of the module, make(real) -> broken)``:
  ``portbench/faults.py`` plants one by swapping that attribute, the
  driver's own way into the program;
- ``READ_FAULTS``: those whose readings may set a limit's upper reading
  (``portbench/control.py`` reads them by default);
- ``control(drv)``: the control's readings, the reference in fp8 in the
  program's place, against the reference.

A later kind of traffic adds a file here and names it in its traffic
files; nothing else changes.
"""
