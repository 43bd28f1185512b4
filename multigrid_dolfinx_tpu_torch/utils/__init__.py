"""State conversion helpers."""
