"""Autotuning: so far the mesh factorizations of the search space, which
the elastic re-plan of a supervised run needs (``tune.space``), and the
store's calibrated peaks (``tune.cache``)."""
