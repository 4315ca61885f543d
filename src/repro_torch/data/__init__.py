"""Synthetic data for the port."""
