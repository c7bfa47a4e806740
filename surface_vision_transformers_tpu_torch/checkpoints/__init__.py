"""Checkpoint IO and weight conversion."""
