"""Feature bookkeeping."""
