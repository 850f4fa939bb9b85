"""Reinitialization of a level set to a signed distance function."""

from .eikonal import reinitialize, reinit_rhs
