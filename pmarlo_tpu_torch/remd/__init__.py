"""Replica-exchange MD."""
