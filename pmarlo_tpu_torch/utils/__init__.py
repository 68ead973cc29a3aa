"""Host-side numpy utilities."""
