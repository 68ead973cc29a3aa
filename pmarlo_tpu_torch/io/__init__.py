"""Host-side I/O (PDB)."""
