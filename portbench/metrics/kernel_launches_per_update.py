from portbench.readers import kernel_launches_per_update as read  # noqa: F401
