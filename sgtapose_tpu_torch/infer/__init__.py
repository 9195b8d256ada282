"""Streaming inference."""
