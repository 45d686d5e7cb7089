"""One module a way of driving the system, ``<entry>.py``, named by the
``entry`` key of a traffic mix (``mixes/<traffic>.json``, data only).

A module defines ``chunk(solver, u, n, params)``: ``n`` updates of the
state ``u`` through the solver's public entry, returning the state it
hands on, the updates it completed and the residual it read back (None
where it reads none); ``PARAMS``, the mix keys of its own; and
``RESIDUAL``, whether its answers carry a residual to check.
"""
