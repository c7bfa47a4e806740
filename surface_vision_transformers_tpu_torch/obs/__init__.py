"""Run folders and metric logs."""
