"""Workflows (test-time evaluation)."""
