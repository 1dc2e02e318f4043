"""The inference batch."""
