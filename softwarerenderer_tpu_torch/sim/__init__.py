"""Simulation: the raycast physics query (``sim.raycast``)."""
