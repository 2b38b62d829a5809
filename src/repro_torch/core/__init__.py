"""Host-side models and the lane engine of the port."""
