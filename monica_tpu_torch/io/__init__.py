"""Host-side sequence I/O and encoding (numpy)."""
