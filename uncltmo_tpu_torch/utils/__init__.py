"""Host I/O and checkpoint conversion."""
