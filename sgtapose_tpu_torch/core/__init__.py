"""Geometry and PnP."""
