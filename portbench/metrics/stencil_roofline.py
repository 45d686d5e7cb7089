from portbench.readers import stencil_roofline as read  # noqa: F401
