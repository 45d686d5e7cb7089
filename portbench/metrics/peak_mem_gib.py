from portbench.readers import peak_mem_gib as read  # noqa: F401
