"""Geometric queries."""
