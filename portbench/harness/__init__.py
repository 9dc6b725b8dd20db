"""The benchmark's machinery, shared by every cell: the manifest
(``manifest``), the card (``device``), inputs and weights from the seed
(``inputs``, ``weights``), what every driver takes from the program
(``program``), the traced windows (``trace``), the arithmetic (``stats``)
and one run of a cell (``cell``).  The drivers of the kinds of traffic are
in ``portbench/drivers/``, the metrics' readers in ``portbench/metrics/``."""
