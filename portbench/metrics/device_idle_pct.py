from portbench.readers import device_idle_pct as read  # noqa: F401
