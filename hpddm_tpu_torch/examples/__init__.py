"""Example drivers of the port."""
