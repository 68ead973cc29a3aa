"""Dataset-level analysis: discretization and validation."""
