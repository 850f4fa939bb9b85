"""Shapes and velocity fields."""
