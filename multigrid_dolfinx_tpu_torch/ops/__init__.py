"""Operators, transfers, smoothers, coarse solve and the kernel dispatch."""
