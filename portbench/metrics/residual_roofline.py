from portbench.readers import residual_roofline as read  # noqa: F401
