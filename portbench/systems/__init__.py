"""One module a system under test, ``<system>.py``, named by the ``system``
key of a configuration file. It builds the program's solver from the whole
file and refuses a key it does not consume, builds the comparison's control,
gives the plain reference of the same equation, and moves a field between
the benchmark's whole-grid tensor and the program's state.

A module defines:

- ``solver(config, run, device, grid)``: the system under test, where
  ``run`` holds the mix's run settings;
- ``control(config, run, device, grid)``: the same one precision below,
  which the comparison has to find not correct;
- ``reference(config, device, shape)``: an object whose ``run(u, steps,
  residual_dtype)`` gives the field after ``steps`` updates and, with a
  dtype, the L2 norm of the last update's change;
- ``state(solver, u)`` and ``field(solver, state)``: the benchmark's field
  as the program's state, and back.
"""
