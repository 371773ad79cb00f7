"""The drivers: one module a kind of traffic (``batch``, ``daemon``,
``train``), each with ``setup``, ``window``, ``release``, ``check`` and the
names of the ``READINGS`` its check can compare (a cell's file gives a
limit to those it compares)."""
