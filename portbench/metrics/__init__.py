"""One file a metric, ``<metric>.py``, whose ``read(ctx)`` gives the
metric's value from the run's context, or None where it finds nothing to
read; most bind a function of ``portbench.readers``.

``ctx`` holds ``config`` and ``mix`` (the cell's files), ``grid``, ``gpus``
and ``run`` (``portbench.drive.Run``: the window's host-clock seconds,
updates, the program's launch count over the window, the memory peaks,
the set-up times, and in a traced run ``activity``, the profiled window's
device activity from ``portbench.timeline``, over ``profiled_updates``).
"""
