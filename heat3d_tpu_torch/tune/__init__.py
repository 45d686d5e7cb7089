"""Autotuning: so far only the mesh factorizations of the search space,
which the elastic re-plan of a supervised run needs (``tune.space``)."""
