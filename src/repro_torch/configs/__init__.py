"""Engine configurations of the port."""
