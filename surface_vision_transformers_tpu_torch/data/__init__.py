"""Dataset IO (numpy)."""
