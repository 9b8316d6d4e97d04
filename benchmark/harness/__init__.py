"""The benchmark's general parts: the run (``core``), the trace reduction
(``trace``), the seeded weights (``weights``) and the card's peaks
(``peaks``).  Nothing here names a configuration, a traffic mix or a
metric: those are files found by name (see ``benchmark/README.md``)."""
