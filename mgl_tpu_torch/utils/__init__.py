"""Metrics, logging and the opt-in self-check of the port."""
