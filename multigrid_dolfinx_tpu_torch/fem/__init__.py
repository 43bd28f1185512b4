"""Finite-element setup: P1 elements, prototype assembly, norms and the
on-device const level builder."""
