"""Helpers for holding the port against the reference package."""
