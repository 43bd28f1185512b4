"""Hierarchy, V-cycle and the FMG / tolerance drivers."""
