"""Utilities: fault injection and device resolution."""
