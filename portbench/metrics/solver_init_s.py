from portbench.readers import solver_init_s as read  # noqa: F401
