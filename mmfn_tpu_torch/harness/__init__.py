"""Closed-loop serving."""
