"""Fault tolerance and elasticity (the port's copy of ``repro.runtime``)."""
