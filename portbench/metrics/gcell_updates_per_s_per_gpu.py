from portbench.readers import gcell_updates_per_s_per_gpu as read  # noqa: F401
