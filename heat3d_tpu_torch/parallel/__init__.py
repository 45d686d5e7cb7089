"""Step, superstep, fixed-step and convergence loops (single device)."""
