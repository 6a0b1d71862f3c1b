"""Host-side buffer helpers."""
