"""Host-side utilities: device timing."""
