"""Input parsing and host batch building for the port."""
