"""Host-side data feeds of the port (counterpart of repro.data)."""
